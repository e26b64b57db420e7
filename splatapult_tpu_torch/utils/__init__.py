"""Host-side helpers (image I/O, the camera overlay)."""

from splatapult_tpu_torch.utils.image import save_png, load_png, composite_to_rgb
from splatapult_tpu_torch.utils.overlay import camera_overlay_lines, draw_lines

__all__ = ["save_png", "load_png", "composite_to_rgb", "camera_overlay_lines", "draw_lines"]
