"""The summation order of the port's SVM kernel, in plain PyTorch, against
the JAX package on the CPU; the launch plan, the bias rule and the
wrapper's one launch.

``csrc/svm.cu`` runs only on the card (``chip_smoke.py`` phase 2 holds it
against the plain version there, and ``svm(b)`` against ``svm(0) + b`` bit
for bit).  What can be checked here is its order of summation:
``kernel_order_svm`` below is it step for step, and nothing but this test
uses it.  Each dot product over d takes four partial sums, one per
feature of a group of four, combined as (s0 + s1) + (s2 + s3), then the
d % 4 tail in order; |x|^2 and |sv|^2 the same.  Thread t of a block sums
support vectors t, t + 256, .. in order; a warp's 32 sums meet by a
shuffle tree (offsets 16, 8, 4, 2, 1), the 8 warps' sums in order, then
the bias.  The kernel's fused multiply-adds are a multiply and an add
here, a rounding apart.  Against the JAX ``svm_decision`` (its Pallas
kernel in interpret mode): rtol 1e-4 and atol 1e-5, as
``tests/test_torch_kernels.py`` and phase 2 hold the kernel.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.svm.ops import svm_decision as j_svm
from repro_torch.kernels.svm import ops as svm_ops
from repro_torch.kernels.svm import svm as svm_mod

H100_SMS = 132
CSRC = Path(svm_mod.__file__).resolve().parents[2] / "csrc" / "svm.cu"


def _const(name: str) -> int:
    src = CSRC.read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def dot4(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(p, m) dots of rows a (p, d) with rows v (m, d) in the kernel's
    order."""
    d = a.shape[1]
    d4 = d // 4
    s = torch.zeros(a.shape[0], v.shape[0], 4)
    for c in range(d4):
        s = s + a[:, None, 4 * c:4 * c + 4] * v[None, :, 4 * c:4 * c + 4]
    r = (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])
    for c in range(4 * d4, d):
        r = r + a[:, None, c] * v[None, :, c]
    return r


def kernel_order_svm(x, sv, alpha, b, gamma):
    """The kernel's sums for float32 x (q, d), sv (m, d), alpha (m,)."""
    q, m = x.shape[0], sv.shape[0]
    threads = _const("kThreads")
    dot = dot4(x, sv)
    if gamma is None:
        k = dot
    else:
        xsq = torch.diagonal(dot4(x, x))
        vsq = torch.diagonal(dot4(sv, sv))
        k = torch.exp(-gamma * torch.clamp(xsq[:, None] + vsq[None, :]
                                           - 2.0 * dot, min=0.0))
    terms = alpha[None, :] * k                               # (q, m)
    rounds = -(-m // threads)
    terms = torch.nn.functional.pad(terms, (0, rounds * threads - m))
    acc = torch.zeros(q, threads)
    for r in range(rounds):                  # thread t: vector r * 256 + t
        acc = acc + terms[:, r * threads:(r + 1) * threads]
    v = acc.reshape(q, threads // 32, 32)
    for off in (16, 8, 4, 2, 1):              # lane 0 of the shuffle tree
        v = v[..., :off] + v[..., off:2 * off]
    s = torch.zeros(q)
    for w in range(threads // 32):
        s = s + v[:, w, 0]
    return s + b


CASES = [(128, 256, 36, 0.5), (13, 300, 7, 0.5), (5, 40, 3, None),
         (64, 512, 1024, 0.5)]


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("q,m,d,gamma", CASES)
def test_summation_order_matches_the_jax_svm(q, m, d, gamma, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (q, d)).astype(np.float32)
    # support vectors near the queries, so the RBF values are not all 0
    spread = 0.2 if d < 100 else 0.01
    sv = (x[rng.integers(0, q, m)] + spread * rng.standard_normal((m, d))
          ).astype(np.float32)
    alpha = (rng.standard_normal(m) / m).astype(np.float32)
    b = np.float32(0.1)
    want = np.asarray(j_svm(jnp.asarray(x), jnp.asarray(sv),
                            jnp.asarray(alpha), b, gamma=gamma))
    if gamma is not None:
        assert np.abs(want - b).max() > 1e-3      # the kernel term matters
    got = kernel_order_svm(*(torch.from_numpy(a) for a in (x, sv, alpha)),
                           float(b), gamma).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_plan_covers_the_card_at_tinybio():
    """TinyBio (q 128): one query a block, 128 blocks."""
    assert tuple(svm_mod.plan_svm(128, H100_SMS)) == (1, 128)


def test_plan_is_pure():
    """The same arguments give the same plan; each field follows from
    (q, sm_count) by the documented rule: the most queries a block that
    still give a block per SM, else 1."""
    for args in [(128, 132), (1024, 132), (5, 7)]:
        assert svm_mod.plan_svm(*args) == svm_mod.plan_svm(*args)
    for q in range(1, 3000, 37):
        for sms in (1, 78, 132):
            plan = svm_mod.plan_svm(q, sms)
            assert plan.queries in svm_mod.QUERIES
            assert plan.blocks == -(-q // plan.queries)
            assert plan.blocks >= min(q, sms)     # covers the card where q allows
            bigger = [k for k in svm_mod.QUERIES if k > plan.queries]
            assert all(-(-q // k) < sms for k in bigger)
    assert svm_mod.plan_svm(1024, H100_SMS).queries == 4
    assert svm_mod.plan_svm(1100, H100_SMS).queries == 8
    with pytest.raises(ValueError):
        svm_mod.plan_svm(0, H100_SMS)


def test_the_kernel_matches_the_binding():
    """The threads a block and the queries a block the kernel is compiled
    for (csrc/svm.cu) are the binding's."""
    src = CSRC.read_text()
    assert _const("kThreads") == svm_mod.THREADS
    compiled = tuple(int(k) for k in re.findall(r"case (\d+): return launch_svm<", src))
    assert compiled == svm_mod.QUERIES


def test_bias_rule():
    """A 0-d tensor on the queries' device goes by pointer, as float32; a
    number or a 0-d CPU tensor by value; anything else raises."""
    cpu = torch.device("cpu")
    b64 = torch.tensor(0.1, dtype=torch.float64)
    dev, val = svm_mod.bias_args(b64, cpu)
    assert dev.dtype == torch.float32 and float(dev) == np.float32(0.1)
    assert svm_mod.bias_args(0.25, cpu) == (None, 0.25)
    assert svm_mod.bias_args(torch.tensor(0.5), torch.device("meta")) == (None, 0.5)
    with pytest.raises(ValueError, match="0-d"):
        svm_mod.bias_args(torch.zeros(1), cpu)
    with pytest.raises(ValueError, match="bias on"):
        svm_mod.bias_args(torch.tensor(0.5, device="meta"), cpu)


def test_bias_forms_give_the_same_decisions():
    rng = np.random.default_rng(3)
    x, sv = (torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
             for s in ((9, 5), (20, 5)))
    alpha = torch.from_numpy(rng.standard_normal(20).astype(np.float32))
    outs = [svm_ops.svm_decision(x, sv, alpha, b, 0.5)
            for b in (0.1, torch.tensor(0.1), torch.tensor(0.1, dtype=torch.float64))]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def _record_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(svm_mod, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(svm_mod, "stream_of", lambda t: None)
    monkeypatch.setattr(svm_ops, "on_card", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": H100_SMS}))
    return calls


@pytest.mark.parametrize("bias", ["tensor", "float"])
def test_svm_on_the_card_is_one_launch_with_the_bias(monkeypatch, bias):
    """The card path launches once, with the bias as a pointer (a 0-d
    tensor on the queries' device) or a float and the plan's queries, and
    returns the kernel's output itself (no add after it)."""
    calls = _record_launches(monkeypatch)
    x, sv, alpha = torch.zeros(128, 36), torch.zeros(256, 36), torch.zeros(256)
    b = torch.tensor(0.1) if bias == "tensor" else 0.1
    out = svm_ops.svm_decision(x, sv, alpha, b, 0.5)
    (args,) = calls
    assert args[:2] == ("svm", "repro_svm_f32")
    ptrs = [a.value for a in args[3:7]]
    assert ptrs[:3] == [x.data_ptr(), sv.data_ptr(), alpha.data_ptr()]
    if bias == "tensor":
        assert ptrs[3] == b.data_ptr() and args[7] == 0.0
    else:
        assert ptrs[3] is None and args[7] == 0.1
    assert args[8].value == out.data_ptr() and out.shape == (128,)
    assert args[9:15] == (128, 256, 36, 0.5, 1, svm_mod.plan_svm(128, H100_SMS).queries)
