from .mapper import FastMapper, Mapper, StitchPlan

__all__ = ["FastMapper", "Mapper", "StitchPlan"]
