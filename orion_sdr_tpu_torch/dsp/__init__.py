from .osc import rotate, rotate_host
from .device import sanitize_iq
from .channelizer import Channelizer, band_compose
from .pfb import pfb_channelize, pfb_channel_freqs, pfb_prototype
from .recurrence import first_order, affine2
from .osc import oscillator, mix_usb
from .fir import (fir_lowpass_design, kaiser_beta, bessel_i0,
                  kaiser_lowpass_taps, kaiser_transition_norm, kaiser_num_taps,
                  half_cosine_taps, group_delay, fir_apply, fir_filter_aligned,
                  fir_filter_aligned_bank, fir_decimate)
from .iir import (BiquadCoefs, design_butter_lp, dc_pole, biquad, biquad_init,
                  BiquadState, lp_cascade, dc_blocker, lp_dc_cascade,
                  lp_dc_init, LpDcState)
from . import agc
from .agc import AgcParams, design_agc, agc_rms
# ``resample`` is the function, as in the JAX package; the module stays
# importable as ``orion_sdr_tpu_torch.dsp.resample`` through the import
# system (``importlib.import_module``).
from .resample import resample, resample_taps, Resampler
