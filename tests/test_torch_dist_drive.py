"""The port's multi-process tools on gloo ranks (the CPU), on ``tiny``.

- ``cli.dist_drive`` (4 images, 2 epochs, the restart after epoch 0, arm
  P on 2 ranks for 1 epoch): arm C's per-epoch losses equal arm B's bit
  for bit, B's first epoch within the tool's 2% of arm A's, arm P trains
  with split state leaves on a (1, 2) mesh; ``dist_drive_torch.json``
  holds them; the JAX tool's ``DIST_DRIVE.json`` is refused.
- ``cli.scaling_test`` (1 and 2 ranks, 64 px, 1 round of 2 steps): every
  rank count warms and is timed, and the largest group's first step on
  the parity batch equals the 1-process step's loss within rel 2e-5.
  Its curve gate is not asserted here (``--tolerance 1``): gloo ranks of
  a 64 px net on shared cores are bound by their collectives, which the
  artifact records; ``SCALING.json`` is refused.
"""
import json
import os

import pytest

from improved_body_parts_torch.cli import dist_drive, scaling_test


def test_dist_drive_resume_is_exact_and_topology_within_tolerance(tmp_path):
    out = tmp_path / "dist_drive_torch.json"
    result = dist_drive.main([
        "--config", "tiny", "--images", "4", "--epochs", "2",
        "--resume-after", "1", "--partition-epochs", "1",
        "--partition-processes", "2", "--device", "cpu",
        "--workdir", str(tmp_path / "work"), "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(
        json.dumps(result, allow_nan=False))
    b, c = (result["two_process_straight_losses"],
            result["two_process_resumed_losses"])
    assert len(b) == 2 and c == b and result["resume_exact"]
    assert result["topology_rel_diff_per_epoch"][0] <= 0.02
    assert result["parity_ok"]
    p = result["partitioned"]
    assert p["ok"] and p["mesh"] == {"data": 1, "model": 2}
    assert p["realized_state_sharding"]["sharded"] > 0
    work = tmp_path / "work"
    assert os.path.isfile(work / "ckpt_dist" / "epoch_1" / "COMMIT.json")


@pytest.mark.parametrize("tool,name", [(dist_drive, "DIST_DRIVE.json"),
                                       (scaling_test, "SCALING.json")])
def test_the_jax_tools_artifacts_are_refused(tool, name, tmp_path):
    with pytest.raises(SystemExit, match="JAX tool's"):
        tool.main(["--device", "cpu", "--out", str(tmp_path / name)])


def test_scaling_test_runs_the_protocol_with_loss_parity(tmp_path):
    out = tmp_path / "scaling_torch.json"
    art = scaling_test.main([
        "--devices", "1", "2", "--steps", "2", "--rounds", "1",
        "--image-size", "64", "--device", "cpu", "--tolerance", "1.0",
        "--out", str(out)])
    assert json.loads(out.read_text())["devices"] == [1, 2]
    assert art["loss_parity"]["ok"]
    assert art["loss_parity"]["partitioned_mesh"] == {"data": 2, "model": 1}
    for n in ("1", "2"):
        r = art["results"][n]
        assert len(r["imgs_per_sec_rounds"]) == 1
        assert r["imgs_per_sec_median"] > 0 and r["first_step_finite"]
        assert r["global_batch"] == int(n)
