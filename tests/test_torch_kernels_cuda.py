"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here carries the `cuda` marker and skips
without a GPU. The file imports no JAX, so it runs on a GPU machine without
it (there: `python -m pytest tests/test_torch_kernels_cuda.py -m cuda
--noconftest -q`, since tests/conftest.py pins JAX)."""

import pytest
import torch

from polyaxon_tpu_torch.models import build_model
from polyaxon_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.device("cuda")


KERNEL_CASES = [
    # B, S, H, KV, D, causal, dtype
    (1, 4096, 32, 8, 64, True, torch.bfloat16),
    (2, 512, 4, 4, 128, False, torch.float32),
    (1, 1024, 8, 2, 32, True, torch.bfloat16),
    (2, 48, 4, 1, 64, True, torch.float32),
    (1, 200, 2, 2, 64, False, torch.bfloat16),
]


@pytest.mark.parametrize("B,S,H,KV,D,causal,dtype", KERNEL_CASES)
def test_flash_fwd_matches_plain_version(cuda_device, B, S, H, KV, D, causal, dtype):
    """o is held per row: max |err| of each (b, s, h) vector over that
    row's max |o_ref|, so late causal rows with small |o| count as much as
    early ones. bf16: o within 2^-6 of the row (each side rounds p and o to
    bf16, up to 2^-8 relative each; the kernel rounds p against its running max,
    the plain version against the row max), lse within 1e-3. f32: o within
    1e-5 of the row, lse within 1e-4 (sum order only)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (
        torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
        for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    )
    before = fa.FLASH_FWD.launches
    with torch.no_grad():
        o, lse = fa.flash_attention_lse(q, k, v, causal=causal, block_q=8, block_kv=8)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
    o_tol, lse_tol = (2.0 ** -6, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-4)
    assert o.dtype == dtype and lse.dtype == torch.float32
    err = (o.float() - o_ref.float()).abs().amax(-1)
    assert (err / o_ref.float().abs().amax(-1)).max().item() < o_tol
    assert (lse - lse_ref).abs().max().item() < lse_tol


def test_flash_fwd_reads_strided_inputs(cuda_device):
    """q/k/v as views of one fused projection (non-contiguous heads)."""
    B, S, H, KV, D = 2, 256, 4, 2, 64
    qkv = torch.randn(B, S, (H + 2 * KV) * D, device=cuda_device)
    q = qkv[..., : H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + KV) * D].view(B, S, KV, D)
    v = qkv[..., (H + KV) * D:].view(B, S, KV, D)
    assert not q.is_contiguous()
    with torch.no_grad():
        o = fa.flash_attention(q, k, v)
    ref, _ = fa.flash_attention_reference(q, k, v)
    assert (o - ref).abs().max().item() < 1e-4


def test_flash_fwd_refuses_grad(cuda_device):
    q = torch.randn(1, 64, 2, 32, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        fa.flash_attention(q, q.detach(), q.detach())


def test_flash_fwd_refuses_unsupported_inputs(cuda_device):
    q = torch.randn(1, 64, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    h = torch.randn(1, 64, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(h, h, h)


def test_model_forward_launches_once_per_layer(cuda_device):
    cfg = dict(dim=128, n_layers=3, n_heads=4, n_kv_heads=2, vocab_size=512,
               seq_len=256, attention="flash")
    model = build_model("transformer_lm", cfg, dtype=torch.bfloat16).module
    ref = build_model("transformer_lm", {**cfg, "attention": "xla"},
                      dtype=torch.bfloat16).module
    tokens = torch.randint(0, 512, (2, 256), device=cuda_device)
    before = fa.FLASH_FWD.launches
    with torch.inference_mode():
        out, want = model(tokens).float(), ref(tokens).float()
    assert fa.FLASH_FWD.launches == before + 3
    assert ((out - want).norm() / want.norm()).item() < 2e-2
