"""Sample ingest (host-side, numpy).

Reference parity: src/algorithms/signal_source/ (File_Signal_Source + the
format-specific sources, the LabSat 2/3 source, the custom UDP source and
the rtl_tcp client) and src/algorithms/data_type_adapter/ (Ibyte_To_*,
Ishort_To_*).  The data-type adapter collapses into the reader: every
source yields complex64 baseband blocks ready for device transfer, and the
reference's `gnss_sdr_valve` (bounded stream) becomes the reader's
`max_samples` bound.  Copies of the JAX package's numpy modules.
"""

from .file_source import FileSignalSource, read_capture
from .formats import FORMATS, convert_to_complex64
from .labsat import LabsatSource
from .network import RtlTcpSignalSource, UdpSignalSource

__all__ = ["FileSignalSource", "read_capture", "FORMATS",
           "convert_to_complex64", "LabsatSource", "RtlTcpSignalSource",
           "UdpSignalSource"]
