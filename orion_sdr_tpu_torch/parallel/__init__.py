"""Multi-device scaling (counterpart of ``orion_sdr_tpu/parallel``): a mesh
of shards in one process (``mesh.py``), channel- and time-parallel
sharding (``sharding.py``), time-sharded streaming state and the sharded
DVB-T and COFDM capstones (``streaming.py``), and the cross-process layer
(``distributed.py``)."""

from .mesh import Mesh, Shards
from .sharding import (
    make_mesh,
    shard_channels,
    fir_overlap_save_sharded,
    fm_demod_sharded,
    ofdm_soft_demap_sharded,
    dvb_t_receive_sharded,
)
from .streaming import (
    psk31_demod_sharded,
    psk31_stream_decode_sharded,
    viterbi_decode_sharded,
    forney_deinterleave_sharded,
    dvb_t_receive_time_sharded,
    dvb_t_decode_time_sharded,
    ofdm_frame_decode_time_sharded,
)
from .distributed import (
    init_distributed,
    make_process_mesh,
    ber_sharded,
    power_spectrum_sharded,
    measure_scaling,
    format_scaling_table,
)
