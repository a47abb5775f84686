"""The hybrid family (zamba2-7b's smoke config: five Mamba2 blocks, the
shared attention+MLP block after each group of two, one trailing block)
of the port against the reference on the CPU, f32, with the tolerances
of ``tests/torch_families.py``.

- ``forward_train`` with ``cfg.remat`` (a group per checkpoint) against
  the reference's loss and every gradient, and without it against the
  same; one AdamW step; prefill and 3 decode steps with the conv, SSM
  and per-group KV caches; ``FAMILIES_SMOKE_LOSS`` recomputed.
- The port's teacher-forced decode against its full prefill.
- A checkpoint crosses the packages both ways.
"""
import numpy as np

import torch_families as F

ARCH = "zamba2_7b"


def test_forward_train_matches_reference():
    F.check_train(ARCH)


def test_forward_train_without_remat_matches_reference():
    tree, loss_j, _, grads_j = F.reference_train(ARCH)
    loss_t, _, grads_t = F.port_train(ARCH, tree, remat=False)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    F.assert_trees_close(grads_j, grads_t, atol=1e-5, rtol=1e-4)


def test_adamw_step_matches_reference():
    F.check_adamw_step(ARCH)


def test_prefill_and_decode_match_reference():
    F.check_serve(ARCH)


def test_decode_matches_prefill_hybrid():
    F.check_teacher_forced(ARCH)


def test_families_smoke_loss_is_the_references():
    F.check_smoke_loss(ARCH)


def test_checkpoints_cross_the_packages(tmp_path):
    F.check_checkpoints_cross(ARCH, tmp_path)
