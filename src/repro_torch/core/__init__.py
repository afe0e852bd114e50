"""Crossbar physics: the paper's hardware-robust in-RRAM computing.

  MacroSpec / DEFAULT_MACRO      physical macro description + power model
  NonidealConfig                 Table II effect toggles
  crossbar_forward               structural crossbar simulation of one macro
  IRCLinear / IRCLinearConfig    IRC layer (QAT surrogate + tiled eval)
  ternary_quantize / binary_quantize / binary_activation   STE quantizers
  ternary_planes / binary_planes crossbar mapping schemes
  calibrate_bias                 layerwise extra-bias calibration (Table I)
"""
from repro_torch.core.macro import (MacroSpec, DEFAULT_MACRO, wl_point,
                                    WL_OPERATING_POINTS)
from repro_torch.core.nonideal import (NonidealConfig, sample_variation_mask,
                                       nonlinearity_ratio, apply_nonlinearity,
                                       ir_drop_factors, apply_ir_drop,
                                       sa_required_diff, sa_offset,
                                       sensing_failure, resolve_sa,
                                       sensed_diff)
from repro_torch.core.ternary import (ternary_quantize, binary_quantize,
                                      binary_activation, soft_sa_output,
                                      ternary_fractions,
                                      distribution_regularizer)
from repro_torch.core.mapping import (MappedLayer, ternary_planes,
                                      binary_planes, extend_inputs, tile_rows,
                                      pad_inputs_for_tiles,
                                      fold_bn_to_bias_units)
from repro_torch.core.crossbar import (crossbar_forward, crossbar_apply,
                                       sample_chip_planes, irc_linear_train,
                                       IRCLinear, IRCLinearConfig,
                                       ideal_ternary_matmul,
                                       variation_noise_std)
from repro_torch.core.calibration import (calibrate_bias, sa_error_rates,
                                          layer_current_stats)

__all__ = [
    "MacroSpec", "DEFAULT_MACRO", "wl_point", "WL_OPERATING_POINTS",
    "NonidealConfig", "sample_variation_mask", "nonlinearity_ratio",
    "apply_nonlinearity", "ir_drop_factors", "apply_ir_drop",
    "sa_required_diff", "sa_offset", "sensing_failure", "resolve_sa",
    "sensed_diff", "ternary_quantize", "binary_quantize",
    "binary_activation", "soft_sa_output", "ternary_fractions",
    "distribution_regularizer", "MappedLayer", "ternary_planes",
    "binary_planes", "extend_inputs", "tile_rows", "pad_inputs_for_tiles",
    "fold_bn_to_bias_units", "crossbar_forward", "crossbar_apply",
    "sample_chip_planes", "irc_linear_train", "IRCLinear", "IRCLinearConfig",
    "ideal_ternary_matmul", "variation_noise_std", "calibrate_bias",
    "sa_error_rates", "layer_current_stats"]
