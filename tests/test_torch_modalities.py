"""The stub modalities (llava-next-mistral-7b's smoke config: patch
embeddings before the tokens, the loss masked over them; musicgen-
medium's: frame embeddings in, no token embedding on the training path)
of the port against the reference on the CPU, f32, with the tolerances
of ``tests/torch_families.py``.

- ``forward_train`` loss and every gradient (musicgen's embedding
  gradient is zero in both), one AdamW step, prefill and 3 decode steps
  with their caches; ``FAMILIES_SMOKE_LOSS`` recomputed.
- The vision stub's loss, a reference fault (ROADMAP Queue 3 item 7):
  the reference builds the loss mask as [1, S] and counts one row's
  text tokens, so its loss is the batch size times the mean over the
  text tokens. At batch 1 the two packages agree; at batch 2 the port's
  loss and gradients are the reference's halved.
"""
import numpy as np
import pytest

import torch_families as F

VLM, AUDIO = "llava_next_mistral_7b", "musicgen_medium"


@pytest.mark.parametrize("arch,batch,ref_over",
                         [(VLM, 1, 1.0), (VLM, 2, 2.0), (AUDIO, 2, 1.0)],
                         ids=["vlm_batch1", "vlm_batch2", "audio"])
def test_forward_train_matches_reference(arch, batch, ref_over):
    F.check_train(arch, batch=batch, ref_over=ref_over)


def test_audio_embedding_gets_a_zero_gradient():
    tree, _, _, grads_j = F.reference_train(AUDIO)
    _, _, grads_t = F.port_train(AUDIO, tree)
    assert not np.asarray(grads_j["embed"]).any()
    assert not grads_t["embed"].any()


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_adamw_step_matches_reference(arch):
    F.check_adamw_step(arch)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_prefill_and_decode_match_reference(arch):
    F.check_serve(arch)


@pytest.mark.parametrize("arch,ref_over", [(VLM, F.C["batch"]), (AUDIO, 1)])
def test_families_smoke_loss_is_the_references(arch, ref_over):
    F.check_smoke_loss(arch, ref_over=ref_over)
