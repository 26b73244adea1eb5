"""Block factory registry: reference `implementation=` names -> this port.

Reference parity: GNSSBlockFactory (src/core/receiver/gnss_block_factory.cc
:1249-2300) — a string-keyed registry of ~90 adapter names covering 15+
signal sources, 6 data-type adapters, 6 input filters, 2 resamplers, 27
acquisitions, 24 trackings, 10 telemetry decoders, observables and PVT.

Every reference name is present with the disposition the JAX package gives
it (the same kind, signal, strategy and status):

  kind      — block category (source/adapter/filter/resampler/acquisition/
              tracking/telemetry/observables/pvt/conditioner)
  signal    — 2-char signal id ('1C', '1B', ...) where signal-specific
  strategy  — engine variant selector consumed by the Receiver/CLI
  status    — 'native'   = an implementation of the system
              'collapsed'= hardware-offload variant folded into the native
                           engine (the accelerator runs the native engine)
              'hardware' = requires an RF front-end / external device this
                           build does not drive (raises on use)

`STRATEGY_IMPL` points only at the strategies this port carries (the
acquisition strategies but `assisted`, and `dll_pll`, `veml`, `kf`
tracking); runtime.config.to_receiver_config refuses the others with the
ROADMAP.md item that ports them.  `resolve(name)` returns the
descriptor; unknown names raise (the reference factory logs "Block ... not
found" and returns nullptr, gnss_block_factory.cc:2290-2300).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BlockInfo:
    name: str
    kind: str
    signal: str | None = None
    strategy: str | None = None
    status: str = "native"
    note: str = ""


def _acq(name, signal, strategy="pcps", status="native", note=""):
    return BlockInfo(name, "acquisition", signal, strategy, status, note)


def _trk(name, signal, strategy="dll_pll", status="native", note=""):
    return BlockInfo(name, "tracking", signal, strategy, status, note)


def _tlm(name, signal):
    return BlockInfo(name, "telemetry", signal)


def _src(name, status="native", note=""):
    return BlockInfo(name, "source", None, None, status, note)


_BLOCKS = [
    # ---- signal sources (gnss_block_factory.cc:1256-1459) ----
    _src("File_Signal_Source"),
    _src("Custom_UDP_Signal_Source", note="io.network.UdpSignalSource"),
    _src("RtlTcp_Signal_Source", note="io.network.RtlTcpSignalSource"),
    _src("Nsr_File_Signal_Source", note="io.formats 'nsr' 2-bit real"),
    _src("Two_Bit_Cpx_File_Signal_Source", note="io.formats byte2cpx"),
    _src("Two_Bit_Packed_File_Signal_Source", note="io.formats 2-bit packed"),
    _src("Spir_File_Signal_Source", note="io.formats 'spir' 1-bit int32"),
    _src("Spir_GSS6450_File_Signal_Source",
         note="io.formats 'spir_gss6450_{2,4}bit'"),
    _src("Labsat_Signal_Source", note="io.labsat.LabsatSource (LS2/LS3)"),
    _src("UHD_Signal_Source", "hardware", "USRP RF front-end"),
    _src("GN3S_Signal_Source", "hardware", "GN3S dongle"),
    _src("Raw_Array_Signal_Source", "hardware", "antenna array front-end"),
    _src("Osmosdr_Signal_Source", "hardware", "osmosdr RF front-end"),
    _src("Plutosdr_Signal_Source", "hardware", "ADALM-Pluto front-end"),
    _src("Fmcomms2_Signal_Source", "hardware", "AD9361 FMComms front-end"),
    _src("Ad9361_Fpga_Signal_Source", "hardware", "Zynq AD9361 (FPGA build)"),
    _src("Flexiband_Signal_Source", "hardware", "Teleorbit Flexiband"),
    # ---- conditioner chain (factory :234-252) ----
    BlockInfo("Signal_Conditioner", "conditioner"),
    BlockInfo("Array_Signal_Conditioner", "conditioner", status="hardware",
              note="multi-antenna conditioner"),
    BlockInfo("Pass_Through", "conditioner"),
    # data-type adapters (io/formats.py item types)
    BlockInfo("Byte_To_Short", "adapter"),
    BlockInfo("Ibyte_To_Cbyte", "adapter"),
    BlockInfo("Ibyte_To_Cshort", "adapter"),
    BlockInfo("Ibyte_To_Complex", "adapter"),
    BlockInfo("Ishort_To_Cshort", "adapter"),
    BlockInfo("Ishort_To_Complex", "adapter"),
    # input filters (condition/)
    BlockInfo("Fir_Filter", "filter"),
    BlockInfo("Freq_Xlating_Fir_Filter", "filter"),
    BlockInfo("Notch_Filter", "filter", strategy="notch"),
    BlockInfo("Notch_Filter_Lite", "filter", strategy="notch"),
    BlockInfo("Pulse_Blanking_Filter", "filter", strategy="pulse_blanking"),
    BlockInfo("Beamformer_Filter", "filter", strategy="beamformer",
              note="condition.Beamformer fixed-weight array combiner "
                   "(multi-antenna capture files; RF array is hardware)"),
    # resamplers
    BlockInfo("Direct_Resampler", "resampler"),
    BlockInfo("Fractional_Resampler", "resampler"),
    BlockInfo("Mmse_Resampler", "resampler"),
    # ---- acquisition (factory :1552-1709) ----
    _acq("GPS_L1_CA_PCPS_Acquisition", "1C"),
    _acq("GPS_L1_CA_PCPS_Assisted_Acquisition", "1C", "assisted"),
    _acq("GPS_L1_CA_PCPS_Tong_Acquisition", "1C", "tong"),
    _acq("GPS_L1_CA_PCPS_Acquisition_Fine_Doppler", "1C", "fine_doppler"),
    _acq("GPS_L1_CA_PCPS_QuickSync_Acquisition", "1C", "quicksync"),
    _acq("GPS_L1_CA_PCPS_OpenCl_Acquisition", "1C", "pcps", "collapsed",
         "OpenCL clFFT variant -> batched torch.fft"),
    _acq("GPS_L1_CA_PCPS_Acquisition_Fpga", "1C", "pcps", "collapsed"),
    _acq("GPS_L2_M_PCPS_Acquisition", "2S"),
    _acq("GPS_L2_M_PCPS_Acquisition_Fpga", "2S", "pcps", "collapsed"),
    _acq("GPS_L5i_PCPS_Acquisition", "L5"),
    _acq("GPS_L5i_PCPS_Acquisition_Fpga", "L5", "pcps", "collapsed"),
    _acq("Galileo_E1_PCPS_Ambiguous_Acquisition", "1B"),
    _acq("Galileo_E1_PCPS_Ambiguous_Acquisition_Fpga", "1B", "pcps",
         "collapsed"),
    _acq("Galileo_E1_PCPS_8ms_Ambiguous_Acquisition", "1B", "8ms"),
    _acq("Galileo_E1_PCPS_Tong_Ambiguous_Acquisition", "1B", "tong"),
    _acq("Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition", "1B", "cccwsr"),
    _acq("Galileo_E1_PCPS_QuickSync_Ambiguous_Acquisition", "1B",
         "quicksync"),
    _acq("Galileo_E5a_Pcps_Acquisition", "5X"),
    _acq("Galileo_E5a_Pcps_Acquisition_Fpga", "5X", "pcps", "collapsed"),
    _acq("Galileo_E5a_Noncoherent_IQ_Acquisition_CAF", "5X", "caf"),
    _acq("GLONASS_L1_CA_PCPS_Acquisition", "1G"),
    _acq("GLONASS_L2_CA_PCPS_Acquisition", "2G"),
    _acq("BEIDOU_B1I_PCPS_Acquisition", "B1"),
    _acq("BEIDOU_B3I_PCPS_Acquisition", "B3"),
    # ---- tracking (factory :1713-1850) ----
    _trk("GPS_L1_CA_DLL_PLL_Tracking", "1C"),
    _trk("GPS_L1_CA_DLL_PLL_C_Aid_Tracking", "1C", "dll_pll",
         status="collapsed",
         note="carrier aiding is built into the unified engine (A.4)"),
    _trk("GPS_L1_CA_DLL_PLL_Tracking_GPU", "1C", "dll_pll", "collapsed",
         "CUDA multicorrelator -> the chunk correlator kernel "
         "(csrc/chunk_corr.cuh) or the gather walk kernel "
         "(csrc/gather_block.cu)"),
    _trk("GPS_L1_CA_DLL_PLL_Tracking_Fpga", "1C", "dll_pll", "collapsed"),
    _trk("GPS_L1_CA_KF_Tracking", "1C", "kf",
         note="track.kf.KfTrackingEngine"),
    _trk("GPS_L1_CA_TCP_CONNECTOR_Tracking", "1C", "tcp_connector",
         note="track.tcp_connector: external loop closure over TCP "
              "(JSON protocol; LoopClosureServer is the in-repo "
              "controller template)"),
    _trk("GPS_L2_M_DLL_PLL_Tracking", "2S"),
    _trk("GPS_L2_M_DLL_PLL_Tracking_Fpga", "2S", "dll_pll", "collapsed"),
    _trk("GPS_L5_DLL_PLL_Tracking", "L5"),
    _trk("GPS_L5_DLL_PLL_Tracking_Fpga", "L5", "dll_pll", "collapsed"),
    _trk("GPS_L5i_DLL_PLL_Tracking", "L5"),
    _trk("GPS_L5i_DLL_PLL_Tracking_Fpga", "L5", "dll_pll", "collapsed"),
    _trk("Galileo_E1_DLL_PLL_VEML_Tracking", "1B", "veml"),
    _trk("Galileo_E1_DLL_PLL_VEML_Tracking_Fpga", "1B", "veml", "collapsed"),
    _trk("Galileo_E1_TCP_CONNECTOR_Tracking", "1B", "tcp_connector",
         note="track.tcp_connector with the E1 sinBOC replica"),
    _trk("Galileo_E5a_DLL_PLL_Tracking", "5X"),
    _trk("Galileo_E5a_DLL_PLL_Tracking_Fpga", "5X", "dll_pll", "collapsed"),
    _trk("GLONASS_L1_CA_DLL_PLL_Tracking", "1G"),
    _trk("GLONASS_L1_CA_DLL_PLL_C_Aid_Tracking", "1G", "dll_pll",
         status="collapsed"),
    _trk("GLONASS_L2_CA_DLL_PLL_Tracking", "2G"),
    _trk("GLONASS_L2_CA_DLL_PLL_C_Aid_Tracking", "2G", "dll_pll",
         status="collapsed"),
    _trk("BEIDOU_B1I_DLL_PLL_Tracking", "B1"),
    _trk("BEIDOU_B3I_DLL_PLL_Tracking", "B3"),
    # ---- telemetry decoders ----
    _tlm("GPS_L1_CA_Telemetry_Decoder", "1C"),
    _tlm("GPS_L2C_Telemetry_Decoder", "2S"),
    _tlm("GPS_L5_Telemetry_Decoder", "L5"),
    _tlm("Galileo_E1B_Telemetry_Decoder", "1B"),
    _tlm("Galileo_E5a_Telemetry_Decoder", "5X"),
    _tlm("GLONASS_L1_CA_Telemetry_Decoder", "1G"),
    _tlm("GLONASS_L2_CA_Telemetry_Decoder", "2G"),
    _tlm("BEIDOU_B1I_Telemetry_Decoder", "B1"),
    _tlm("BEIDOU_B3I_Telemetry_Decoder", "B3"),
    _tlm("SBAS_L1_Telemetry_Decoder", "1C"),
    # ---- observables / PVT ----
    BlockInfo("Hybrid_Observables", "observables"),
    BlockInfo("GPS_L1_CA_Observables", "observables"),
    BlockInfo("GPS_L2C_Observables", "observables"),
    BlockInfo("Galileo_E5A_Observables", "observables"),
    BlockInfo("RTKLIB_PVT", "pvt"),
    BlockInfo("GPS_L1_CA_PVT", "pvt"),
    BlockInfo("Galileo_E1_PVT", "pvt"),
    BlockInfo("Hybrid_PVT", "pvt"),
]

REGISTRY: dict[str, BlockInfo] = {b.name: b for b in _BLOCKS}

# strategy -> implementing (module, attribute), for the strategies this
# port carries
STRATEGY_IMPL: dict[tuple[str, str], tuple[str, str]] = {
    ("acquisition", "pcps"): ("gnss_sdr_1_tpu_torch.acquire.pcps",
                              "PcpsAcquisition"),
    ("acquisition", "tong"): ("gnss_sdr_1_tpu_torch.acquire.pcps",
                              "PcpsAcquisition"),      # .acquire_tong
    ("acquisition", "quicksync"): ("gnss_sdr_1_tpu_torch.acquire.variants",
                                   "QuickSyncAcquisition"),
    ("acquisition", "cccwsr"): ("gnss_sdr_1_tpu_torch.acquire.variants",
                                "CccwsrAcquisition"),
    ("acquisition", "fine_doppler"): (
        "gnss_sdr_1_tpu_torch.acquire.variants", "FineDopplerAcquisition"),
    ("acquisition", "8ms"): ("gnss_sdr_1_tpu_torch.acquire.variants",
                             "Pcps8msAcquisition"),
    ("acquisition", "caf"): ("gnss_sdr_1_tpu_torch.acquire.variants",
                             "CafAcquisition"),
    ("tracking", "dll_pll"): ("gnss_sdr_1_tpu_torch.track.engine",
                              "TrackingEngine"),
    ("tracking", "veml"): ("gnss_sdr_1_tpu_torch.track.engine",
                           "TrackingEngine"),
    ("tracking", "kf"): ("gnss_sdr_1_tpu_torch.track.kf", "KfTrackingEngine"),
    ("tracking", "tcp_connector"): ("gnss_sdr_1_tpu_torch.track.tcp_connector",
                                    "TcpConnectorTracking"),
}


def strategy_impl(kind: str, strategy: str):
    """Import and return the implementing class for a strategy."""
    import importlib

    mod, attr = STRATEGY_IMPL[(kind, strategy)]
    return getattr(importlib.import_module(mod), attr)


def resolve(name: str) -> BlockInfo:
    """Look up an `implementation=` name (gnss_block_factory.cc:2290 logs
    and returns nullptr for unknown names; we raise)."""
    info = REGISTRY.get(name)
    if info is None:
        raise KeyError(f"Block implementation '{name}' not in registry "
                       f"({len(REGISTRY)} known names)")
    return info
