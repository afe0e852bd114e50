"""The paper's own model: YOLOv2-style IRC object detector (Fig. 11).

Six binary group-conv layers (group size 60), digital stem and head, on
1024x576 inputs.  `proposed()` and `baseline()` are the two Table II
designs; `smoke(scheme)` is the small geometry the tests and the CLI use.
"""
from repro_torch.models.detector import DetectorConfig

ARCH_ID = "yolo-irc"


def proposed() -> DetectorConfig:
    """Ternary 20/60/20, no BN, single-shot accumulation, 32 bias rows."""
    return DetectorConfig(
        img_hw=(576, 1024), n_classes=3, n_anchors=5, group=60,
        stage_channels=(60, 120, 240), blocks_per_stage=(2, 2, 2),
        scheme="ternary", use_bn=False, accumulation="single_shot",
        bias_rows=32)


def baseline() -> DetectorConfig:
    """Binary weights vs a shared reference line, in-memory BN (96 rows),
    partial-sum accumulation (~300 uA per 212-row chunk at nominal WL)."""
    return DetectorConfig(
        img_hw=(576, 1024), n_classes=3, n_anchors=5, group=60,
        stage_channels=(60, 120, 240), blocks_per_stage=(2, 2, 2),
        scheme="binary", use_bn=True, accumulation="partial_sum",
        bias_rows=0, partial_rows=212)


def smoke(scheme: str = "ternary") -> DetectorConfig:
    """Two-stage 32x32 geometry of either design: "ternary" (proposed, 16
    bias rows) or "binary" (baseline, in-memory BN, partial sums)."""
    kwargs = dict(img_hw=(32, 32), stage_channels=(60, 120),
                  blocks_per_stage=(1, 1), n_classes=3, n_anchors=2)
    if scheme == "ternary":
        return DetectorConfig(scheme="ternary", use_bn=False,
                              accumulation="single_shot", bias_rows=16,
                              **kwargs)
    if scheme != "binary":
        raise ValueError(f"scheme must be 'ternary' or 'binary', got "
                         f"{scheme!r}")
    return DetectorConfig(scheme="binary", use_bn=True,
                          accumulation="partial_sum", bias_rows=0, **kwargs)
