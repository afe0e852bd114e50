"""The port's detector weights from a PRNG key against the JAX package's.

`IRCDetector.init(prng.PRNGKey(s))` must be the reference's
`init(jax.random.PRNGKey(s))` (`materialize`) bit for bit, for both designs
at the smoke geometry and at full width, so that the two CLIs sweep the
same network at the same seed; and the two CLIs' `--network detector`
per-chip mAPs must then agree."""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs import yolo_irc as tcfg  # noqa: E402
from repro_torch.models.detector import IRCDetector  # noqa: E402

torch.set_num_threads(2)


def _assert_same_tree(ref, got, path=""):
    """Same keys, shapes and float32 bit patterns."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _assert_same_tree(ref[k], got[k], f"{path}/{k}")
        return
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype == np.float32, path
    assert got.shape == ref.shape, path
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32),
                                  err_msg=path)


@pytest.mark.parametrize("geometry", ["smoke", "proposed", "baseline"])
@pytest.mark.parametrize("seed", [0, 5])
def test_init_matches_reference_bit_for_bit(geometry, seed):
    from repro.configs import yolo_irc as jcfg
    from repro.models import IRCDetector as JDet
    if geometry == "smoke":
        pairs = [(jcfg.smoke(s), tcfg.smoke(s)) for s in ("ternary",
                                                          "binary")]
    else:
        pairs = [(getattr(jcfg, geometry)(), getattr(tcfg, geometry)())]
    for jc, tc in pairs:
        ref = jax.device_get(JDet(jc).init(jax.random.PRNGKey(seed)))
        got = IRCDetector(tc).init(prng.PRNGKey(seed, device="cpu"),
                                   device="cpu")
        _assert_same_tree(ref, got)


def test_init_draws_where_it_is_asked():
    det = IRCDetector(tcfg.smoke())
    key = prng.PRNGKey(2, device="cpu")
    a = det.init(key, device="cpu")
    b = det.init(key, device="cpu")
    assert torch.equal(a["head"], b["head"])
    assert not torch.equal(a["head"],
                           det.init(prng.PRNGKey(3, device="cpu"),
                                    device="cpu")["head"])
    assert torch.count_nonzero(a["head_b"]) == 0
    assert torch.equal(a["stem_bn"]["var"], torch.ones_like(
        a["stem_bn"]["var"]))


@pytest.mark.parametrize("design", ["ternary", "binary"])
def test_detector_cli_matches_the_jax_cli(design, tmp_path, monkeypatch,
                                          capsys):
    """Both CLIs at the same seed, smoke geometry, 4 chips in chunks of 2,
    every Table II column: the same per-chip mAP@0.5 (within 0.02, the
    near-tie bar of the detector parity tests; the two packages add the
    digital stem and head in other orders)."""
    from repro.launch import mc as jcli
    from repro_torch.launch import mc as tcli
    common = ["--network", "detector", "--det-scheme", design, "--chips",
              "4", "--chunk", "2", "--ablation", "table2", "--seed", "1"]
    jout, tout = tmp_path / "j.json", tmp_path / "t.json"
    monkeypatch.setattr(sys, "argv", ["mc"] + common + [
        "--run-dir", "", "--json", str(jout)])
    with jax.threefry_partitionable(True), prng.threefry_partitionable(True):
        jcli.main()
        tcli.main(common + ["--device", "cpu", "--json", str(tout),
                            "--run-dir", str(tmp_path)])
    capsys.readouterr()
    ref = json.loads(jout.read_text())["results"]["init"]
    got = json.loads(tout.read_text())["results"]["init"]
    assert list(got) == list(ref)
    for name in ref:
        want = np.asarray(ref[name]["per_chip_map50"])
        have = np.asarray(got[name]["per_chip_map50"])
        assert have.shape == want.shape == (4,)
        np.testing.assert_allclose(have, want, atol=0.02, err_msg=name)
