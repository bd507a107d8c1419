from flowerdiff_torch.diffusion.schedule import DiffusionSchedule, linear_schedule

__all__ = ["DiffusionSchedule", "linear_schedule"]
