"""The port's ternary matmul (K3): its plain version and the dispatch of
`repro_torch.kernels.ops.ternary_matmul` against the JAX package's Pallas
kernel (interpret mode) and oracle, the ideal digital reference
`ideal_ternary_matmul`, the shared nvcc build step, and — on a machine with
a card — the CUDA kernel against its plain version.

Same numpy inputs on both sides.  With {0,1} inputs every partial sum is an
integer below 2^24, so any float32 summation order gives the same bits:
bit-exact.  Normal inputs: rtol 1e-6, atol 1e-4 (float32 sums in another
order); bfloat16 inputs: 3e-2, the JAX package's own kernel tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import crossbar as tcb  # noqa: E402
from repro_torch.kernels import build as nvb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ternary_matmul as kern3  # noqa: E402

torch.set_num_threads(2)

SHAPES = [(1, 16, 1), (33, 300, 77), (200, 1000, 40)]


def _case(seed, B, K, N, kind):
    rng = np.random.default_rng(seed)
    if kind == "bits":
        x = (rng.random((B, K)) < 0.5).astype(np.float32)
    else:
        x = rng.standard_normal((B, K)).astype(np.float32)
    w = rng.integers(-1, 2, size=(K, N)).astype(np.int8)
    return x, w


def _jax_pallas(x, w, bf16):
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    return np.asarray(jops.ternary_matmul(xj, jnp.asarray(w), interpret=True))


@pytest.mark.parametrize("kind", ["bits", "normal", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_pallas_and_oracle(shape, kind):
    x, w = _case(sum(shape), *shape, kind)
    bf16 = kind == "bf16"
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
    ops.reset_launches()
    got = ops.ternary_matmul(xt, torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == shape[::2]
    assert ops.LAUNCHES["ternary_matmul"] == 0           # CPU: plain version
    torch.testing.assert_close(got, tref.ternary_matmul_ref(xt, torch.from_numpy(w)),
                               rtol=0, atol=0)
    pallas = _jax_pallas(x, w, bf16)
    oracle = np.asarray(jref.ternary_matmul_ref(
        jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32),
        jnp.asarray(w)))
    for want in (pallas, oracle):
        if kind == "bits":
            np.testing.assert_array_equal(got.numpy(), want)
        elif kind == "normal":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-4)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=3e-2,
                                       atol=3e-2)


def test_ideal_ternary_matmul_matches_reference():
    from repro.core.crossbar import ideal_ternary_matmul as jideal
    rng = np.random.default_rng(11)
    x = (rng.random((64, 540)) < 0.5).astype(np.float32)
    w = rng.integers(-1, 2, size=(540, 60)).astype(np.float32)
    np.testing.assert_array_equal(
        tcb.ideal_ternary_matmul(torch.from_numpy(x),
                                 torch.from_numpy(w)).numpy(),
        np.asarray(jideal(jnp.asarray(x), jnp.asarray(w))))


@pytest.mark.parametrize("bad", [2.0, 0.5, -3.0, float("nan")])
def test_ideal_ternary_matmul_refuses_non_ternary_weights(bad):
    w = torch.zeros((8, 3))
    w[4, 1] = bad
    with pytest.raises(ValueError, match="-1, 0, \\+1"):
        tcb.ideal_ternary_matmul(torch.ones((2, 8)), w)


def test_checks_raise():
    x = torch.ones((4, 8))
    w = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="x \\[B,K\\]"):
        ops.ternary_matmul(x[:, :-1], w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.ternary_matmul(x.double(), w)
    with pytest.raises(ValueError, match="int8"):
        ops.ternary_matmul(x, w.float())


def test_cuda_request_raises_when_kernel_cannot_load(monkeypatch):
    """A CUDA operand never reaches the plain version: if the kernel cannot
    be built or loaded the call raises and counts nothing."""
    def no_kernel():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(ops, "_check_ternary",
                        lambda *a: torch.device("cuda"))
    monkeypatch.setattr(kern3, "load", no_kernel)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.ternary_matmul(torch.ones((2, 4)),
                           torch.ones((4, 3), dtype=torch.int8))
    assert ops.LAUNCHES["ternary_matmul"] == 0


def _fake_nvcc(tmp_path, log):
    """A stand-in `$CUDA_HOME/bin/nvcc` that records its call and writes
    the `-o` file."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
        "  shift\n"
        "done\n"
        "echo 'ptxas info : Used 40 registers' >&2\n")
    nvcc.chmod(0o755)
    return tmp_path / "cuda"


def test_build_compiles_each_stale_source_once(monkeypatch, tmp_path):
    """One library per source; a library newer than its source is kept, a
    stale one is rebuilt; every nvcc call targets sm_90a."""
    import os
    log = tmp_path / "calls.log"
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, log)))
    monkeypatch.setattr(nvb, "build_dir", lambda: tmp_path / "build")
    srcs = [tmp_path / "a.cu", tmp_path / "b.cu"]
    for s in srcs:
        s.write_text("// kernel\n")
    libs = nvb.build(*srcs)
    assert [p.name for p in libs] == ["liba.so", "libb.so"]
    assert all(p.is_file() for p in libs)
    calls = log.read_text().splitlines()
    assert len(calls) == 2 and all("code=sm_90a" in c for c in calls)
    assert "Used 40 registers" in nvb.BUILD_LOG["a.cu"]
    nvb.build(*srcs)
    assert len(log.read_text().splitlines()) == 2        # up to date
    assert nvb.BUILD_S["a.cu"] == 0.0
    future = libs[1].stat().st_mtime + 10
    os.utime(srcs[1], (future, future))
    nvb.build(*srcs)
    calls = log.read_text().splitlines()
    assert len(calls) == 3 and calls[-1].endswith("b.cu")


def test_both_kernels_build_from_csrc():
    assert kern3.SOURCE.is_file() and kern3.SOURCE.parent == nvb.CSRC
    assert nvb.library_path(kern3.SOURCE).name == "libternary_matmul.so"


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bits", "normal", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_matches_plain_version(cuda_device, shape, kind):
    x, w = _case(sum(shape), *shape, kind)
    xt = torch.from_numpy(x).to(cuda_device)
    if kind == "bf16":
        xt = xt.to(torch.bfloat16)
    wt = torch.from_numpy(w).to(cuda_device)
    ops.reset_launches()
    got = ops.ternary_matmul(xt, wt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ternary_matmul"] == 1
    want = tref.ternary_matmul_ref(xt, wt)
    if kind == "bits":
        assert torch.equal(got, want)
    elif kind == "normal":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
