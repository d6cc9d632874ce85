from .blenders import (
    FeatherPlan,
    MultiBandPlan,
    build_feather_plan,
    build_multiband_plan,
    feather_blend,
    multiband_blend,
)
from .gain import GainPlan, build_gain_plan, solve_gains
from .mapper import FastMapper, Mapper, StitchPlan

__all__ = [
    "Mapper",
    "FastMapper",
    "StitchPlan",
    "GainPlan",
    "build_gain_plan",
    "solve_gains",
    "FeatherPlan",
    "MultiBandPlan",
    "build_feather_plan",
    "build_multiband_plan",
    "feather_blend",
    "multiband_blend",
]
