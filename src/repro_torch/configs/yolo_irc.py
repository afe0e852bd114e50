"""The paper's own model: YOLOv2-style IRC object detector (Fig. 11).

Six ternary group-conv layers (group size 60), digital stem and head, on
1024x576 inputs.  `proposed()` is the Table II proposed design; `smoke()` is
the small geometry the tests use.
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


def smoke() -> DetectorConfig:
    """Two-stage 32x32 geometry of the proposed design (16 bias rows)."""
    return DetectorConfig(img_hw=(32, 32), stage_channels=(60, 120),
                          blocks_per_stage=(1, 1), n_classes=3, n_anchors=2,
                          scheme="ternary", use_bn=False,
                          accumulation="single_shot", bias_rows=16)
