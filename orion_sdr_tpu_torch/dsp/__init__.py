from .osc import rotate, rotate_host
from .device import sanitize_iq
