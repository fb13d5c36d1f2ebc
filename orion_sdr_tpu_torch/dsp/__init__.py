from .osc import rotate, rotate_host
from .device import sanitize_iq
from .channelizer import Channelizer, band_compose
from .pfb import pfb_channelize, pfb_channel_freqs, pfb_prototype
