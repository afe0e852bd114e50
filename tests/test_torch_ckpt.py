"""The port's checkpoints against the JAX package's (`repro.ckpt`): a
checkpoint written by either restores in the other, float32 and bfloat16
leaves bit-identical, and both write the same files (META.json equal apart
from `time`, the npz members byte for byte); the atomic `.tmp`, keep-k,
`save_async`, `latest_step`, the KeyError the serving CLI falls back on,
and a bfloat16 restore in a process where `ml_dtypes` cannot be
imported."""
import json
import subprocess
import sys
import textwrap
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro_torch import ckpt as tckpt

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _trees(dtype: str):
    """The same tree in both packages: nested params of `dtype`, an int32
    counter and a float32 vector."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 5)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    v = rng.normal(size=(4,)).astype(np.float32)
    jt = {"params": {"w": jnp.asarray(w).astype(jd),
                     "b": jnp.asarray(b).astype(jd)},
          "step": jnp.arange(2, dtype=jnp.int32), "m": jnp.asarray(v)}
    tt = {"params": {"w": torch.from_numpy(w).to(td),
                     "b": torch.from_numpy(b).to(td)},
          "step": torch.arange(2, dtype=torch.int32),
          "m": torch.from_numpy(v)}
    return jt, tt


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _bits_j(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _bits_t(t: torch.Tensor) -> np.ndarray:
    size = t.element_size()
    return t.view(getattr(torch, f"int{8 * size}")).numpy().view(f"u{size}")


def _same(jt, tt) -> None:
    jf, tf = dict(_flat(jt)), dict(_flat(tt))
    assert list(jf) == list(tf)
    for k in jf:
        assert str(np.asarray(jf[k]).dtype) == str(tf[k].dtype).split(".")[-1]
        assert np.array_equal(_bits_j(jf[k]), _bits_t(tf[k])), k


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_jax_written_restores_in_port(tmp_path, dtype):
    jt, tt = _trees(dtype)
    jckpt.save_pytree(jt, tmp_path, step=4)
    assert tckpt.latest_step(tmp_path) == 4
    got = tckpt.restore_pytree(tt, tmp_path, device="cpu")
    _same(jt, got)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_written_restores_in_jax(tmp_path, dtype):
    jt, tt = _trees(dtype)
    tckpt.save_pytree(tt, tmp_path, step=9)
    assert jckpt.latest_step(tmp_path) == 9
    got = jckpt.restore_pytree(jax.eval_shape(lambda: jt), tmp_path)
    _same(got, tt)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_files_identical_apart_from_time(tmp_path, dtype):
    jt, tt = _trees(dtype)
    a = jckpt.save_pytree(jt, tmp_path / "jax", step=2)
    b = tckpt.save_pytree(tt, tmp_path / "port", step=2)
    assert a.name == b.name == "step_000000002"
    assert sorted(p.name for p in a.iterdir()) == \
        sorted(p.name for p in b.iterdir()) == ["META.json", "host_0.npz"]
    ma = json.loads((a / "META.json").read_text())
    mb = json.loads((b / "META.json").read_text())
    ma.pop("time"), mb.pop("time")
    assert list(ma) == list(mb) and ma == mb
    assert ma["dtypes"]["params/w"] == dtype
    with zipfile.ZipFile(a / "host_0.npz") as za, \
            zipfile.ZipFile(b / "host_0.npz") as zb:
        assert za.namelist() == zb.namelist()
        for n in za.namelist():
            assert za.read(n) == zb.read(n), n


def test_template_dtype_and_meta_template(tmp_path):
    """Each leaf is cast to its template leaf's dtype; `meta` tensors serve
    as a template."""
    jt, tt = _trees("bfloat16")
    jckpt.save_pytree(jt, tmp_path, step=1)
    tmpl = {"params": {"w": torch.empty((3, 5), device="meta"),
                       "b": torch.empty((7,), dtype=torch.bfloat16,
                                        device="meta")},
            "step": torch.empty((2,), dtype=torch.int32, device="meta"),
            "m": torch.empty((4,), device="meta")}
    got = tckpt.restore_pytree(tmpl, tmp_path, device="cpu")
    assert got["params"]["w"].dtype == torch.float32
    assert torch.equal(got["params"]["w"], tt["params"]["w"].float())
    assert got["params"]["b"].device.type == "cpu"


def test_atomic_tmp_is_invisible(tmp_path):
    (tmp_path / "step_000000009.tmp").mkdir(parents=True)
    assert tckpt.latest_step(tmp_path) is None
    assert tckpt.latest_step(tmp_path / "absent") is None
    # a step directory without META.json is not a checkpoint either
    (tmp_path / "step_000000003").mkdir()
    assert tckpt.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_pytree({"w": torch.zeros(1)}, tmp_path, device="cpu")


def test_keep_k_gc(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path, keep=2)
    tree = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(tree, s)
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.iterdir() if p.is_dir())
    assert steps == [3, 4] and mgr.saved_steps == [1, 2, 3, 4]


def test_save_async_snapshots(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path, keep=3)
    w = torch.ones(4)
    mgr.save_async({"w": w}, 1)
    w.add_(1.0)                    # the snapshot was taken before this
    mgr.wait()
    assert tckpt.latest_step(tmp_path) == 1
    tree, step = mgr.restore_latest({"w": torch.zeros(4)}, device="cpu")
    assert step == 1 and torch.equal(tree["w"], torch.ones(4))
    got = jckpt.restore_pytree({"w": jax.ShapeDtypeStruct((4,),
                                                          jnp.float32)},
                               tmp_path)
    assert np.array_equal(np.asarray(got["w"]), np.ones(4, np.float32))


def test_restore_latest_empty_and_shardings(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path)
    assert mgr.restore_latest({"w": torch.zeros(1)}, device="cpu") == \
        (None, None)
    mgr.save({"w": torch.zeros(1)}, 5)
    with pytest.raises(ValueError):
        mgr.restore_latest({"w": torch.zeros(1)}, shardings={"w": 0},
                           device="cpu")


def test_missing_key_raises_keyerror(tmp_path):
    """A training checkpoint (params under `params/`) refuses a
    params-only template with KeyError, and restores under
    {"params": template}: the serving CLI's fallback."""
    jt, tt = _trees("float32")
    jckpt.save_pytree(jt, tmp_path, step=6)
    mgr = tckpt.CheckpointManager(tmp_path)
    with pytest.raises(KeyError):
        mgr.restore_latest(tt["params"], device="cpu")
    tree, step = mgr.restore_latest({"params": tt["params"]}, device="cpu")
    assert step == 6
    _same(jt["params"], tree["params"])


def test_bf16_restore_without_ml_dtypes(tmp_path):
    """A bfloat16 checkpoint written by the JAX package restores in a
    process where importing `ml_dtypes` fails."""
    jt, tt = _trees("bfloat16")
    jckpt.save_pytree(jt, tmp_path, step=3)
    expect = _bits_t(tt["params"]["w"]).tolist()
    code = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None      # import ml_dtypes -> error
        import torch
        from repro_torch.ckpt import restore_pytree
        tmpl = {{"params": {{"w": torch.empty((3, 5), dtype=torch.bfloat16),
                            "b": torch.empty(7, dtype=torch.bfloat16)}},
                 "step": torch.empty(2, dtype=torch.int32),
                 "m": torch.empty(4)}}
        got = restore_pytree(tmpl, {str(tmp_path)!r}, device="cpu")
        w = got["params"]["w"]
        assert w.dtype == torch.bfloat16
        assert w.view(torch.int16).numpy().view("u2").tolist() == {expect!r}
        assert "ml_dtypes" not in sys.modules or sys.modules["ml_dtypes"] \\
            is None
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_other_bit_pattern_dtype_refused(tmp_path):
    """A leaf stored as a bit pattern of a dtype other than bfloat16 (a
    float8 the JAX package can write) raises TypeError, never the KeyError
    the serving CLI reads as a layout fallback."""
    jckpt.save_pytree({"w": jnp.ones(3, jnp.float8_e4m3fn)}, tmp_path, step=1)
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        tckpt.restore_pytree({"w": torch.zeros(3)}, tmp_path, device="cpu")
