"""The port's model zoo against the reference's on the modality stubs: hubert-xlarge (frames in, masked codebook
loss, not causal: no decode) and llama-3.2-vision-90b (cross-attention
to vision tokens, its gates opened to 0.5 in the carried weights so the
vision path is held).

Each smoke config in f32 with remat off, on the reference's
``init_params`` weights carried across as numpy and one numpy batch
(``_torch_models.Pair``): the loss and aux losses (rtol 1e-5), every
gradient leaf (``torch.autograd.grad`` against ``jax.value_and_grad``,
within 1e-4 of the leaf's max-abs), the prefill logits (1e-4 of their
max-abs) and 12 decode steps' logits against the reference's
``apply_decode`` step by step (1e-4); the port with remat on gives the
same gradients (1e-6), and its own decode reproduces its prefill
(capacity 8.0; atol 2e-3, rtol 2e-2).
"""
import pytest

import _torch_models as tmh

ARCHS = ['hubert_xlarge', 'llama32_vision_90b']
CAUSAL = ['llama32_vision_90b']
DECODABLE = [a for a in ARCHS if a in tmh.DECODABLE]


@pytest.fixture(scope="module")
def pair(request):
    return tmh.Pair(request.param)


@pytest.mark.parametrize("pair", ARCHS, indirect=True)
def test_train_loss_and_aux_match_reference(pair):
    tmh.check_train_loss(pair)


@pytest.mark.parametrize("pair", ARCHS, indirect=True)
def test_train_grads_match_reference(pair):
    tmh.check_train_grads(pair)


@pytest.mark.parametrize("pair", ARCHS, indirect=True)
def test_remat_gives_the_same_grads(pair):
    tmh.check_remat_grads(pair)


@pytest.mark.parametrize("pair", ARCHS, indirect=True)
def test_prefill_logits_match_reference(pair):
    tmh.check_prefill(pair)


@pytest.mark.parametrize("pair", CAUSAL, indirect=True)
def test_decode_logits_match_reference_step_by_step(pair):
    tmh.check_decode(pair)


@pytest.mark.parametrize("pair", DECODABLE, indirect=True)
def test_decode_matches_own_prefill(pair):
    tmh.check_decode_matches_prefill(pair)
