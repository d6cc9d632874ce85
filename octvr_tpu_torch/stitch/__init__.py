from .mapper import Mapper, StitchPlan

__all__ = ["Mapper", "StitchPlan"]
