"""Serve-time predictor factories: checkpoints → dtype'd predictors (the
port's counterpart of ``improved_body_parts_tpu/serve/artifacts.py``).

:func:`checkpoint_predictor` builds the model of a config, loads a
checkpoint of the port's ``train.checkpoint`` (or a seeded init) and
applies the weight storage through ``utils.precision.apply_serve_dtype``,
the same construction site the evaluate CLI uses.
:func:`cascade_predictors` is the two-tier wiring: a cheap-storage
student under a full-precision teacher, which ``serve.cascade
.CascadeEngine.build`` wires into its two tiers.
"""
from __future__ import annotations

from typing import Optional, Tuple


def checkpoint_predictor(config: str = "canonical",
                         checkpoint: Optional[str] = None,
                         params_dtype: str = "fp32",
                         boxsize: int = 0, bucket: int = 128,
                         compact_topk: int = 64,
                         assembly_pmax: int = 32,
                         fused_tta: bool = True,
                         seed: int = 0, device="cuda"):
    """A serving ``Predictor`` of ``config``'s model on ``device``
    (``cuda`` unless the caller asks for ``cpu``), with the weights of
    ``checkpoint`` (an epoch directory of ``train.checkpoint``) or, when
    it is None, the seeded init of ``seed``; ``params_dtype`` is fp32,
    bf16, auto or int8 (``utils.precision``)."""
    from ..config import InferenceModelParams, get_config
    from ..infer import Predictor
    from ..models import build_model
    from ..utils.precision import apply_serve_dtype

    cfg = get_config(config)
    model = build_model(cfg, device=device, seed=seed)
    if checkpoint:
        from ..train import restore_checkpoint

        model.load_state_dict(restore_checkpoint(checkpoint)["model"],
                              strict=True)
    model = apply_serve_dtype(params_dtype, model)
    model_params = (InferenceModelParams(boxsize=boxsize) if boxsize
                    else None)
    return Predictor(model, cfg.skeleton, model_params=model_params,
                     bucket=bucket, compact_topk=compact_topk,
                     assembly_pmax=assembly_pmax, fused_tta=fused_tta,
                     device=device)


def cascade_predictors(student_config: str = "tiny_student",
                       teacher_config: str = "canonical",
                       student_checkpoint: Optional[str] = None,
                       teacher_checkpoint: Optional[str] = None,
                       student_dtype: str = "int8",
                       teacher_dtype: str = "fp32",
                       **kwargs) -> Tuple[object, object]:
    """The cascade's (student, teacher) predictor pair: a cheap-storage
    student (int8 by default) under a full-precision teacher; extra
    kwargs go to both factories."""
    student = checkpoint_predictor(student_config, student_checkpoint,
                                   params_dtype=student_dtype, **kwargs)
    teacher = checkpoint_predictor(teacher_config, teacher_checkpoint,
                                   params_dtype=teacher_dtype, **kwargs)
    return student, teacher
