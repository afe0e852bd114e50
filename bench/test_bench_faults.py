"""The check that decides `correct` catches a broken timed path: each cell
run at smoke size on the CPU (the harness's look for a card skipped) with
the program broken underneath reads `correct` false, once for each fault
such a cell can have: half of the batch left out (the mean taken over the
rest), and an answer altered where it is produced.  A sweep or a service
has no step whose state could stay unchanged and no exchange between
chips."""
import argparse
import time

import pytest
import torch

from benchkit import main, registry, smoke

torch.set_num_threads(2)
SPEC = registry.load_spec()


def _run(cell, **config):
    parts = smoke.parts(SPEC, cell)
    parts["config"].update(config)
    args = argparse.Namespace(workload=cell, seed=(1 << 32) + 99,
                              seconds=smoke.seconds(parts), trace=0)
    return main.run_cell(SPEC, parts, args, torch.device("cpu"),
                         time.perf_counter())


def _half_images(monkeypatch):
    import repro_torch.mc.detector_mc as dm
    real = dm._sample_and_forward

    def half(params, images, *a, **k):
        return real(params, images[: max(1, images.shape[0] // 2)], *a, **k)
    monkeypatch.setattr(dm, "_sample_and_forward", half)


def _shifted_heads(monkeypatch):
    from repro_torch.models.detector import IRCDetector
    real = IRCDetector.apply
    monkeypatch.setattr(IRCDetector, "apply",
                        lambda self, *a, **k: real(self, *a, **k) + 0.01)


def _raised_map(monkeypatch):
    import repro_torch.train.det_loss as dl
    real = dl.evaluate_map_per_chip
    monkeypatch.setattr(dl, "evaluate_map_per_chip",
                        lambda *a, **k: real(*a, **k) + 0.1)


def _half_vectors(monkeypatch):
    import repro_torch.mc.engine as eng
    real = eng.ensemble_apply_kernel

    def half(ens, x_bits, **k):
        out = real(ens, x_bits[: x_bits.shape[0] // 2], **k)
        return torch.cat([out, out], dim=1)
    monkeypatch.setattr(eng, "ensemble_apply_kernel", half)


def _flipped_column(monkeypatch):
    import repro_torch.mc.engine as eng
    real = eng.ensemble_apply_kernel

    def flip(*a, **k):
        out = real(*a, **k).clone()
        out[..., 0] = 1.0 - out[..., 0]
        return out
    monkeypatch.setattr(eng, "ensemble_apply_kernel", flip)


def _raised_agreement(monkeypatch):
    import repro_torch.mc.engine as eng
    real = eng.bit_agreement_metric
    monkeypatch.setattr(eng, "bit_agreement_metric",
                        lambda ref: (lambda out: real(ref)(out) + 0.01))


def _half_committee(monkeypatch):
    import repro_torch.serve.detector as sd
    real = sd.committee_wave_forward

    def half(params, images, keys, chip_ids, *a, **k):
        n = max(1, chip_ids.shape[0] // 2)
        out = real(params, images, keys, chip_ids[:n], *a, **k)
        return out.repeat_interleave(chip_ids.shape[0] // n, dim=1)
    monkeypatch.setattr(sd, "committee_wave_forward", half)


def _shifted_committee(monkeypatch):
    import repro_torch.serve.detector as sd
    real = sd.committee_wave_forward
    monkeypatch.setattr(sd, "committee_wave_forward",
                        lambda *a, **k: real(*a, **k) + 0.01)


def _raised_confidence(monkeypatch):
    from repro_torch.serve.detector import DetectorServeEngine
    real = DetectorServeEngine._top_score
    monkeypatch.setattr(DetectorServeEngine, "_top_score",
                        lambda self, pred: real(self, pred) + 0.1)


def _half_scored(monkeypatch):
    import numpy as np
    import repro_torch.train.det_loss as dl
    real = dl.evaluate_map_per_chip

    def half(preds, *a, **k):
        preds = np.asarray(preds)
        return real(preds[:, : max(1, preds.shape[1] // 2)], *a, **k)
    monkeypatch.setattr(dl, "evaluate_map_per_chip", half)


def _undecoded(monkeypatch):
    import numpy as np
    import repro_torch.serve.detector as sd

    def nothing(pred, *a, **k):
        return (np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                np.zeros(0, np.int64))
    monkeypatch.setattr(sd, "decode_detections", nothing)


#: every box passes the threshold: at the cells' own random weights none
#: does, so no comparison there can see scoring or decoding cut short
DENSE = {"objectness_prior": 0.5}

FAULTS = [("det-proposed-all", _half_images, "head_mismatch", {}),
          ("det-proposed-all", _shifted_heads, "head_mismatch", {}),
          ("det-proposed-all", _raised_map, "map_gap", {}),
          ("det-proposed-all", _half_scored, "map_gap", DENSE),
          ("layer-macro-all", _half_vectors, "bits_mismatch", {}),
          ("layer-macro-all", _flipped_column, "bits_mismatch", {}),
          ("layer-macro-all", _raised_agreement, "agreement_gap", {}),
          ("layer-macro-measured365", _flipped_column, "bits_mismatch", {}),
          ("serve-proposed-c8", _half_committee, "head_mismatch", {}),
          ("serve-proposed-c8", _shifted_committee, "head_mismatch", {}),
          ("serve-proposed-c8", _raised_confidence, "answer_gap", {}),
          ("serve-proposed-c8", _undecoded, "answer_gap", DENSE)]


@pytest.mark.parametrize("cell,fault,number,config", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f, _, _ in FAULTS])
def test_a_broken_timed_path_reads_not_correct(monkeypatch, cell, fault,
                                               number, config):
    fault(monkeypatch)
    rec = _run(cell, **config)
    assert not rec["correct"]
    c = rec["checks"][number]
    assert c["value"] > c["limit"], rec["checks"]
