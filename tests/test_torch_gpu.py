"""The port on the card: K1 built from source and held against its plain
version, and the serving path counting its launches.

Run on a machine with a CUDA device (it imports no JAX):

    python -m pytest -m gpu tests/test_torch_gpu.py -q

Without a card every test here skips; with one, a missing ``nvcc`` fails.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import Model

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),   # tests/test_kernels.py:15
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, S, H, K, hd, hdv, dtype, device):
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 .to(device, dtype)
                 for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hdv)))


@pytest.mark.parametrize("B,S,H,K,hd,hdv,causal,dtype", [
    (2, 256, 4, 4, 128, 128, True, torch.bfloat16),
    (2, 300, 8, 2, 64, 64, True, torch.bfloat16),     # GQA 4:1, ragged S
    (1, 130, 4, 1, 16, 16, False, torch.bfloat16),    # MQA, hd 16
    (1, 96, 2, 2, 192, 128, True, torch.bfloat16),    # hd != hd_v
    (2, 200, 4, 2, 128, 128, True, torch.float32),
])
def test_kernel_matches_plain(cuda, B, S, H, K, hd, hdv, causal, dtype):
    q, k, v = _inputs(B, S, H, K, hd, hdv, dtype, cuda)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal)
    torch.testing.assert_close(got.float(), want.transpose(1, 2).float(),
                               **TOL[dtype])


def test_kernel_refuses_grad(cuda):
    q = torch.zeros((1, 64, 2, 16), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, q.detach(), q.detach())


def test_serving_prefill_runs_k1_once_per_layer(cuda):
    cfg = configs.get_smoke("chatglm3-6b")
    model = Model(cfg, dtype=torch.float32,
                  device=cuda).init(torch.Generator(cuda).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
    with torch.inference_mode():
        cache = model.init_cache(2, 48)
        before = ops.flash_attention.launches
        tok, logits, cache = serve.prefill(model, cache, prompts)
        assert ops.flash_attention.launches == before + cfg.n_layers
        serve.decode(model, cache, tok, 40, 4)
        assert ops.flash_attention.launches == before + cfg.n_layers
        plain = Model(cfg, RunConfig(attn_impl="plain"),
                      dtype=torch.float32, device=cuda)
        plain.load_state_dict(model.state_dict())
        _, want, _ = serve.prefill(plain, plain.init_cache(2, 48), prompts)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
