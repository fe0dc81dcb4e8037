"""The flash-attention backward's host-side plan, on the CPU.

``csrc/flash_attention_bwd.cu`` has two routes: its tensor-core kernels
(``flash_dq_wgmma_kernel``, ``flash_dkdv_wgmma_kernel``) for bfloat16 at
Dk = Dv in ``BWD_MMA_HEAD_DIMS`` (and MLA's (192, 128): see
``tests/test_torch_flash_mla_backward.py``), hubert's D = 80 among them, and
its CUDA-core kernels for float32.  The route is chosen on the host by dtype
and head dim (``bwd_route``) and passed to the C entry point; a head dim
neither route takes is refused with a ``ValueError`` naming the roadmap item
that extends it, never computed some other way.  The kernels themselves run
only on the card (``chip_smoke.py`` phase 2).
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import (check_backward,
                                                     flash_attention)


@pytest.mark.parametrize("d", [32, 64, 80, 96, 128, 256])
def test_bf16_at_the_mma_head_dims_takes_the_tensor_cores(d):
    assert d in fa.BWD_MMA_HEAD_DIMS
    assert fa.bwd_route(torch.bfloat16, d) == "wgmma"
    assert fa.bwd_route(torch.float32, d) == "cuda_cores"


def test_hubert_heads_stay_on_the_cuda_cores():
    """hubert's heads (D = 80) stay on the CUDA cores in float32 (the CPU
    parity route) and take the tensor cores in bfloat16, both ways."""
    assert 80 in fa.BWD_HEAD_DIMS and 80 in fa.BWD_MMA_HEAD_DIMS
    assert fa.bwd_route(torch.bfloat16, 80) == "wgmma"
    assert fa.bwd_route(torch.float32, 80) == "cuda_cores"
    assert (80, 80) in fa.MMA_HEAD_DIMS


def test_the_mma_head_dims_are_the_forwards():
    """Every tensor-core backward width has a tensor-core forward at
    Dk = Dv, so a bf16 training layer runs on the tensor cores both ways."""
    assert set(fa.BWD_MMA_HEAD_DIMS) <= set(fa.BWD_HEAD_DIMS)
    assert all((d, d) in fa.MMA_HEAD_DIMS for d in fa.BWD_MMA_HEAD_DIMS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 192, 160])
def test_a_head_dim_no_route_takes_is_refused(dtype, d):
    with pytest.raises(ValueError, match="Dk = Dv"):
        fa.bwd_route(dtype, d)


@pytest.mark.parametrize("dk,dv", [(192, 192), (160, 160), (96, 64)])
def test_unported_shapes_are_refused_naming_the_roadmap(dk, dv):
    with pytest.raises(ValueError, match="ROADMAP.md queue 2 item 6"):
        check_backward(dk, dv, 0)


def test_a_suffix_q_offset_is_refused():
    """A context-parallel shard's rows (q_offset >= 0) have a backward;
    rows before key 0 (a negative offset) have none."""
    check_backward(64, 64, 16)
    with pytest.raises(ValueError, match="q_offset"):
        check_backward(64, 64, -16)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, 1), (torch.bfloat16, 128, 1), (torch.bfloat16, 32, 1),
    (torch.bfloat16, 96, 1), (torch.bfloat16, 80, 1), (torch.float32, 64, 0),
    (torch.float32, 128, 0)])
def test_the_launch_passes_the_route(monkeypatch, dtype, d, route):
    calls = []
    monkeypatch.setattr(fa, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(fa, "stream_of", lambda t: None)
    b, h, kvh, s, t = 2, 4, 2, 5, 7
    q = torch.zeros(b, h, s, d, dtype=dtype)
    k = torch.zeros(b, kvh, t, d, dtype=dtype)
    lse = torch.zeros(b, h, s)
    fa.launch_flash_attention_bwd(q, k, k, q, lse, lse, q, k, k, causal=True,
                                  scale=0.125)
    (args,) = calls
    assert args[0] == "flash_attention_bwd"
    assert args[1] == {torch.bfloat16: "repro_flash_attention_bwd_bf16",
                       torch.float32: "repro_flash_attention_bwd_f32"}[dtype]
    # ..., b, h, kvh, s, t, dk, dv, scale, causal, q_offset, wgmma, part,
    # device, stream
    assert args[12:23] == (b, h, kvh, s, t, d, d, 0.125, 1, 0, route)
    # the GQA group's f32 dK/dV partials on the tensor-core route only
    assert (args[23].value is not None) == bool(route)
    assert len(args[2]) == len(args) - 3          # one ctypes type an argument


def test_an_mha_call_takes_no_partials(monkeypatch):
    """H = KVH (stablelm): one dK/dV block a kv head, no partials."""
    calls = []
    monkeypatch.setattr(fa, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(fa, "stream_of", lambda t: None)
    q = torch.zeros(2, 4, 5, 64, dtype=torch.bfloat16)
    lse = torch.zeros(2, 4, 5)
    fa.launch_flash_attention_bwd(q, q, q, q, lse, lse, q, q, q, causal=True,
                                  scale=0.125)
    assert calls[0][22] == 1 and calls[0][23].value is None


def test_the_cpu_gradient_is_the_plain_versions():
    """On the CPU the differentiable wrapper runs autograd of the plain
    version at any route's shapes (no kernel, no launch)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 9, 64, generator=g, requires_grad=True)
    k = torch.randn(1, 1, 9, 64, generator=g, requires_grad=True)
    v = torch.randn(1, 1, 9, 64, generator=g, requires_grad=True)
    flash_attention(q, k, v).sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in (q, k, v))
