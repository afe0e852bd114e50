"""The port's causal flash attention (K4) against the JAX package.

`repro_torch.kernels.flash_attention` (the op: the plain version for CPU
tensors, the CUDA kernel for CUDA tensors) and `flash_attention_ref` are
held against the reference's op `repro.kernels.flash_attention` (its
Pallas kernel in interpret mode here) and its oracle `flash_attention_ref`,
on the same numpy inputs, at the shapes of `tests/test_kernels.py::
TestFlashAttention`.  Tolerances are that file's: atol 2e-5 and rtol 1e-4
in float32 (the kernel's online softmax against one softmax over all
keys), 3e-2 in bfloat16 (one bf16 rounding of the output).  The CUDA leg
runs on the card only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:             # hypothesis optional: the sweep then skips
    def given(*_a, **_k):
        return lambda f: pytest.mark.skip(
            reason="hypothesis not installed")(f)

    def settings(*_a, **_k):
        return lambda f: f

    class _NoStrategies:
        def __getattr__(self, _name):
            return lambda *a, **k: None

    st = _NoStrategies()

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import (flash_attention,  # noqa: E402
                                 flash_attention_ref)

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)
# (H, S, hd, reference bq, reference bk): tests/test_kernels.py's shapes
SHAPES = [(2, 64, 16, 16, 16), (4, 128, 32, 32, 64), (1, 100, 16, 32, 32),
          (2, 256, 64, 128, 128)]


def _qkv(H, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((H, Sq, hd)).astype(np.float32),
            rng.standard_normal((H, Sk, hd)).astype(np.float32),
            rng.standard_normal((H, Sk, hd)).astype(np.float32))


def _jax(q, k, v, bq, bk, dtype=jnp.float32):
    from repro.kernels import flash_attention as jflash
    from repro.kernels import flash_attention_ref as jref
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    return (np.asarray(jflash(*args, bq=bq, bk=bk), np.float32),
            np.asarray(jref(*args), np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[1]}x{s[2]}")
def test_op_matches_reference(shape):
    H, S, hd, bq, bk = shape
    q, k, v = _qkv(H, S, S, hd, S)
    j_op, j_ref = _jax(q, k, v, bq, bk)
    T = torch.from_numpy
    out = flash_attention(T(q), T(k), T(v))
    plain = flash_attention_ref(T(q), T(k), T(v))
    assert out.dtype == torch.float32 and out.shape == (H, S, hd)
    np.testing.assert_allclose(out.numpy(), j_op, **F32)
    np.testing.assert_allclose(plain.numpy(), j_ref, **F32)
    np.testing.assert_allclose(plain.numpy(), j_op, **F32)


def test_bf16_matches_reference():
    q, k, v = _qkv(2, 128, 128, 32, 0)
    j_op, j_ref = _jax(q, k, v, 64, 64, jnp.bfloat16)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    out = flash_attention(bf(q), bf(k), bf(v))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), j_op, **BF16)
    np.testing.assert_allclose(out.float().numpy(), j_ref, **BF16)


@pytest.mark.parametrize("Sq,Sk,bq,bk", [(64, 40, 32, 32), (96, 40, 32, 16),
                                         (40, 64, 32, 32)])
def test_ragged_sq_sk_follow_the_oracle(Sq, Sk, bq, bk):
    """Sq != Sk with Sk not a multiple of the key tile.  The reference's
    wrapper then takes the whole of Sk as its key tile (its `bk_`), so it
    pads no zero keys and agrees with the oracle; the port masks keys past
    Sk inside the kernel and agrees with both."""
    q, k, v = _qkv(2, Sq, Sk, 16, Sq + Sk)
    j_op, j_ref = _jax(q, k, v, bq, bk)
    np.testing.assert_allclose(j_op, j_ref, **F32)
    T = torch.from_numpy
    np.testing.assert_allclose(flash_attention(T(q), T(k), T(v)).numpy(),
                               j_ref, **F32)


@settings(max_examples=8, deadline=None)
@given(H=st.integers(1, 4), S=st.sampled_from([32, 64, 96, 160]),
       hd=st.sampled_from([16, 32]), seed=st.integers(0, 2**16))
def test_property_matches_reference(H, S, hd, seed):
    q, k, v = _qkv(H, S, S, hd, seed)
    j_op, _ = _jax(q, k, v, 32, 32)
    T = torch.from_numpy
    np.testing.assert_allclose(flash_attention(T(q), T(k), T(v)).numpy(),
                               j_op, **F32)


def test_checks_and_launch_counter():
    """CPU calls take the plain version and count no launch; misuse
    raises."""
    q = torch.zeros(1, 8, 16)
    ops.reset_launches()
    flash_attention(q, q, q)
    assert ops.LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, q, q, causal=False)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(torch.zeros(1, 8, 24), torch.zeros(1, 8, 24),
                        torch.zeros(1, 8, 24))
    with pytest.raises(ValueError, match="bq and bk"):
        flash_attention(q, q, q, bq=128)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attention(q, q.bfloat16(), q)


def test_package_attribute_stays_the_op():
    """`repro_torch.kernels.flash_attention` is the op before and after its
    first calls: loading the CUDA binding (a module of another name) must
    not rebind the package's attribute."""
    import repro_torch.kernels as K
    from repro_torch.kernels import flash_attention_cuda
    q = torch.from_numpy(_qkv(1, 16, 16, 16, 3)[0])
    first = K.flash_attention(q, q, q)
    second = K.flash_attention(q, q, q)
    assert K.flash_attention is ops.flash_attention
    assert torch.equal(first, second)
    assert flash_attention_cuda.SOURCE.name == "flash_attention.cu"


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel against its plain version, f32 and bf16, at the
    reference's shapes and a ragged Sq > Sk case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cases = [(H, S, S, hd) for H, S, hd, _, _ in SHAPES] + [(2, 96, 40, 16)]
    for H, Sq, Sk, hd in cases:
        q, k, v = (torch.from_numpy(a).to(dev)
                   for a in _qkv(H, Sq, Sk, hd, Sq))
        for bq in (32, 64):
            torch.testing.assert_close(flash_attention(q, k, v, bq=bq, bk=bq),
                                       flash_attention_ref(q, k, v), **F32)
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        torch.testing.assert_close(flash_attention(qb, kb, vb).float(),
                                   flash_attention_ref(qb, kb, vb).float(),
                                   **BF16)
