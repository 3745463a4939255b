"""Rank bodies for ``test_torch_dist.py`` and ``test_torch_distill.py``:
each runs in a spawned process of a gloo group and reports to the parent
through a queue.  A module of its own (not a test file), so a rank
imports torch and the port only."""
import os


def _state(cfg, state_dict):
    import torch

    from improved_body_parts_torch.models import build_model
    from improved_body_parts_torch.train import (
        create_train_state,
        make_optimizer,
        step_decay_schedule,
    )

    model = build_model(cfg, device="cpu", train=True).to(torch.float64)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    opt = make_optimizer(model, cfg, step_decay_schedule(cfg.train, 2))
    return create_train_state(model, cfg, opt)


def _full(state):
    """Every tensor of the state, full (a collective), as float64 numpy."""
    from improved_body_parts_torch.train.checkpoint import _named_state

    return {k: v.detach().double().numpy().copy()
            for k, v in _named_state(state).items()}


def bn_float32(rank, x, w):
    """One float32 :class:`BatchNorm` over the ranks' rows of ``x``
    (rank ``r`` holds rows ``[r*B, (r+1)*B)``), its output and the
    gradient of ``sum(y * w)``: the rank's rows of the output and of the
    input's gradient, the affine gradients summed over the ranks, and the
    running mean."""
    import torch

    from improved_body_parts_torch.models.layers import BatchNorm

    b = x.shape[0] // 2
    bn = BatchNorm(x.shape[1])
    bn.group = torch.distributed.group.WORLD
    bn.train()
    xl = torch.from_numpy(x[rank * b:(rank + 1) * b]).requires_grad_(True)
    y = bn(xl)
    (y * torch.from_numpy(w[rank * b:(rank + 1) * b])).sum().backward()
    affine = torch.cat([bn.weight.grad, bn.bias.grad])
    torch.distributed.all_reduce(affine)
    return {"y": y.detach().numpy(), "x_grad": xl.grad.numpy(),
            "affine_grad": affine.numpy(),
            "running_mean": bn.running_mean.numpy().copy()}


def two_rank_checks(rank, port, payload, out):
    """The 2-rank group of ``test_torch_dist.py``: the three layouts'
    steps, the eval step, a 2-rank checkpoint, and the resume of a
    1-process checkpoint.  Rank 0 reports the states; every rank reports
    what it must agree on."""
    try:
        import torch

        torch.set_num_threads(1)
        from improved_body_parts_torch.parallel import (
            get_ruleset,
            initialize_distributed,
            make_mesh,
            mesh_topology,
            shard_batch,
            shutdown_distributed,
            train_state_shardings,
        )
        from improved_body_parts_torch.train import (
            CheckpointManager,
            TopologyChanged,
            make_eval_step,
            make_train_step,
            restore_checkpoint,
        )
        from improved_body_parts_torch.train.supervisor import (
            reshard_on_topology_change,
        )

        initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
        cfg, batches = payload["cfg"], payload["batches"]
        res = {"bn_f32": bn_float32(rank, *payload["bn_f32"])}
        for name, shape in payload["arms"]:
            mesh = make_mesh(*shape, device="cpu")
            state = _state(cfg, payload["state_dict"])
            rules = get_ruleset(name)
            # the layout of the full state, before the step lays it out
            layout = train_state_shardings(state.model, state.optimizer,
                                           mesh, rules)
            step = make_train_step(state.model, cfg, state.optimizer,
                                   mesh=mesh, rules=rules, health=True)
            steps, first = [], None
            for batch in batches:
                state, loss, gnorm = step(state, *shard_batch(batch, mesh))
                steps.append((float(loss), float(gnorm)))
                if first is None:
                    first = _full(state)
            params = dict(state.model.named_parameters())
            momentum = {f"momentum/{n}": b for n, b in zip(
                params, state.optimizer.momentum)}
            kept = []
            for lay in layout.values():
                t = params.get(lay.key, momentum.get(lay.key))
                if t is None or lay.dim is None:
                    continue
                kept.append((lay.key, tuple(t.shape), lay.dim, lay.shards))
            arm = {"steps": steps, "kept": kept,
                   "sharded_state": state.sharding is not None,
                   "first_state": first, "state": _full(state)}
            if name == "replicated":
                eval_step = make_eval_step(state.model, cfg, mesh=mesh)
                arm["eval"] = float(eval_step(state,
                                               *shard_batch(batches[0],
                                                            mesh)))
                manager = CheckpointManager(
                    payload["ckpt2"], async_save=False,
                    topology=mesh_topology(mesh))
                manager.save(state, 0, steps[-1][0], steps[-1][0])  # graftlint: disable=JGL001 -- the port's step updates the state in place and hands it back; torch donates no buffer
                manager.close()
                torch.distributed.barrier()
            res[name] = arm if rank == 0 else {
                "steps": steps, "kept": kept}
        # the 1-process checkpoint the parent wrote, in 2 ranks
        mesh = make_mesh(2, 1, device="cpu")
        path = payload["ckpt1"]
        state = _state(cfg, payload["state_dict"])
        state, meta = restore_checkpoint(path, state)
        state, change = reshard_on_topology_change(
            state, meta, mesh, 2, "adjust", path, log_fn=lambda s: None)
        res["resume_adjust"] = {"change": change, "step": state.step,
                                "state": _full(state) if rank == 0
                                else None}
        try:
            reshard_on_topology_change(state, meta, mesh, 2, "refuse", path)
            res["resume_refuse"] = None
        except TopologyChanged as e:
            res["resume_refuse"] = str(e)
        out.put((rank, res))
        shutdown_distributed()
    except BaseException as e:
        out.put((rank, {"error": f"{type(e).__name__}: {e}"}))
        raise


def distill_states(cfg, teacher_cfg, student_sd, teacher_sd):
    """(student state, teacher) in float64 from numpy state dicts."""
    import torch

    from improved_body_parts_torch.models import build_model

    state = _state(cfg, student_sd)
    teacher = build_model(teacher_cfg, device="cpu").to(torch.float64)
    teacher.load_state_dict({k: torch.from_numpy(v)
                             for k, v in teacher_sd.items()})
    return state, teacher.eval()


def distill_two_ranks(rank, port, payload, out):
    """The multi-rank distillation step on a (2, 1) mesh: each rank
    distils its rows of every global batch; reports each step's loss
    and grad norm, the state after the first step and after the last
    (rank 0), and the teacher's digest."""
    try:
        import torch

        torch.set_num_threads(1)
        from improved_body_parts_torch.cli.train import state_digest
        from improved_body_parts_torch.parallel import (
            initialize_distributed,
            make_mesh,
            shard_batch,
            shutdown_distributed,
        )
        from improved_body_parts_torch.train import (
            bind_teacher,
            make_distill_train_step,
        )

        initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
        mesh = make_mesh(2, 1, device="cpu")
        state, teacher = distill_states(
            payload["cfg"], payload["teacher_cfg"], payload["student"],
            payload["teacher"])
        digest = state_digest(teacher.state_dict())
        step = bind_teacher(make_distill_train_step(
            state.model, teacher, payload["cfg"], state.optimizer,
            health=True, mesh=mesh), teacher)
        steps, first = [], None
        for batch in payload["batches"]:
            state, loss, gnorm = step(state, *shard_batch(batch, mesh))
            steps.append((float(loss), float(gnorm)))
            if first is None and rank == 0:
                first = _full(state)
        res = {"steps": steps,
               "teacher_unchanged": state_digest(teacher.state_dict())
               == digest,
               "state_sha": state_digest(state.model.state_dict())}
        if rank == 0:
            res.update(first=first, state=_full(state))
        out.put((rank, res))
        shutdown_distributed()
    except BaseException as e:
        out.put((rank, {"error": f"{type(e).__name__}: {e}"}))
        raise


def spawn_group(target, n, payload, timeout_s=240.0):
    """Run ``target(rank, port, payload, queue)`` on ``n`` spawned ranks;
    returns ``{rank: result}``, raising on a rank's error."""
    import multiprocessing as mp

    from improved_body_parts_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=target, args=(r, port, payload, out),
                             daemon=True) for r in range(n)]
        for p in procs:
            p.start()
    finally:
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env
    got = {}
    try:
        for _ in procs:
            rank, res = out.get(timeout=timeout_s)
            got[rank] = res
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    for rank, res in got.items():
        if "error" in res:
            raise RuntimeError(f"rank {rank}: {res['error']}")
    return got
