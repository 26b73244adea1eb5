"""Configuration system: reference-compatible `Block.property=value` files.

Reference parity: ConfigurationInterface with FileConfiguration (INI via
INIReader, section-less keys like `Acquisition_1C.doppler_max=5000`) and
InMemoryConfiguration (the universal test mock) —
src/core/receiver/file_configuration.{h,cc}, in_memory_configuration.{h,cc}.
Reference .conf files parse unchanged; `to_receiver_config` maps the
reference property names onto ReceiverConfig, and `build_frontend` realizes
the SignalConditioner chain (DataTypeAdapter -> InputFilter -> Resampler,
signal_conditioner.cc + factory wiring gnss_block_factory.cc:234-252).

This port carries GPS L1 C/A ('1C'), L2CM ('2S') and L5 ('L5'), Galileo
E1B ('1B') and E5a ('5X'), GLONASS L1/L2 C/A ('1G'/'2G') and BeiDou
B1I/B3I ('B1'/'B3') channel groups with PCPS, Tong, QuickSync, CCCWSR,
fine-Doppler, 8 ms or (on E5a) CAF acquisition, DLL/PLL (VEML on E1B;
`Tracking_XX.correlator` picks the chunked or the gather correlator) or
KF tracking (the receiver builds it on every signal; the conf key
GPS_L1_CA_KF_Tracking names it on GPS L1 C/A only, as in the JAX
package), single-point PVT and the monitor taps (GNSS-SDR.enable_monitor,
Monitor.*, PVT.enable_monitor); a conf with several groups maps to one ReceiverConfig
per group (`to_receiver_configs`, run by runtime.multi_receiver).
`to_receiver_config` refuses everything else with NotImplementedError naming
the ROADMAP.md item that ports it, so no conf maps quietly to an engine
other than the one it names.  As in the JAX package, no conf key maps to
`fdma_k`: a conf's GLONASS group runs every slot at k = 0.
"""

from __future__ import annotations

import dataclasses

from .receiver import _DECODERS, ReceiverConfig

# ROADMAP.md §1, "What later slices port": the item that ports each part a
# conf or a CLI flag may ask for
ROADMAP_ITEMS = {
    "ppp_rtk": "ROADMAP.md §1 item 3 (PPP, RTK and --base_obs)",
    "assistance": "ROADMAP.md §1 item 4 (SUPL and assistance)",
    "signals": "ROADMAP.md §1 (no item: the port runs every signal, "
               "acquisition strategy and tracking block of the JAX package, "
               "and the JAX package has no such one either)",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: {ROADMAP_ITEMS[item]}")


class InMemoryConfiguration:
    """String-keyed property store with typed getters (reference API)."""

    def __init__(self, props: dict[str, str] | None = None):
        self._props: dict[str, str] = dict(props or {})

    def set_property(self, key: str, value) -> None:
        self._props[key] = str(value)

    def property(self, key: str, default):
        """Typed getter: return type follows the default's type."""
        raw = self._props.get(key)
        if raw is None:
            return default
        if isinstance(default, bool):
            return raw.strip().lower() in ("true", "1", "yes", "on")
        if isinstance(default, int):
            return int(float(raw))
        if isinstance(default, float):
            return float(raw)
        return raw

    def keys(self):
        return self._props.keys()

    def items(self):
        return self._props.items()


class FileConfiguration(InMemoryConfiguration):
    """Parse a GNSS-SDR style .conf file: `key=value` lines, `;`/`#`
    comments, optional `[section]` headers (ignored, as in the reference's
    section-less convention)."""

    def __init__(self, path: str):
        super().__init__()
        with open(path, "r", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith((";", "#", "[")):
                    continue
                if "=" not in line:
                    continue
                key, _, value = line.partition("=")
                # strip trailing comments
                for c in (";", "#"):
                    if c in value:
                        value = value.split(c, 1)[0]
                self._props[key.strip()] = value.strip()


def conf_signal_groups(conf: InMemoryConfiguration) -> list[str]:
    """Signal ids of every configured channel group, in conf order — the
    reference's set_signals_list builds per-constellation satellite lists
    from the Channels_XX.count keys (gnss_flowgraph.cc:1722)."""
    groups: list[str] = []
    for key in conf.keys():
        if key.startswith("Channels_") and key.endswith(".count"):
            sid = key[len("Channels_"):-len(".count")]
            if sid and int(conf.property(key, 0)) > 0 and sid not in groups:
                groups.append(sid)
    if not groups:
        # fall back to the acquisition implementation names present
        for key in conf.keys():
            if key.startswith("Acquisition_") and key.endswith(
                    ".implementation"):
                sid = key[len("Acquisition_"):-len(".implementation")]
                if sid and sid not in groups:
                    groups.append(sid)
    return groups or ["1C"]


@dataclasses.dataclass
class FrontEnd:
    """The realized SignalConditioner chain: complex64 samples at the
    source rate in, complex64 at the internal rate (baseband) out."""

    source_fs_hz: float
    internal_fs_hz: float
    if_freq_hz: float = 0.0
    filter_impl: str = "Pass_Through"
    resampler_impl: str = "Pass_Through"
    n_taps: int = 65

    def process(self, x, device=None):
        """Condition a capture: the mixer and FIR run on `device` (None:
        the card, raising without one; the CPU only when asked for), the
        resamplers on the host.  Returns complex64 numpy."""
        import numpy as np

        from ..condition.filters import (
            Conditioner, design_lowpass_fir, direct_resample,
            fractional_resample)

        fs_in, fs_out = self.source_fs_hz, self.internal_fs_hz
        needs_filter = (self.if_freq_hz != 0.0
                        or self.filter_impl in ("Fir_Filter",
                                                "Freq_Xlating_Fir_Filter"))
        if needs_filter:
            ratio = fs_in / fs_out
            decim = int(round(ratio)) if abs(
                ratio - round(ratio)) < 1e-9 and ratio >= 1.0 else 1
            cutoff = 0.45 * min(fs_in / max(decim, 1), fs_out)
            taps = design_lowpass_fir(self.n_taps, cutoff, fs_in)
            cond = Conditioner(taps, fs_in, self.if_freq_hz, decim,
                               device=device)
            x = cond.process(x, flush=True)
            fs_in = fs_in / decim
        else:
            x = np.asarray(x, dtype=np.complex64)
        if abs(fs_in - fs_out) > 1e-6:
            if self.resampler_impl in ("Fractional_Resampler",
                                       "Mmse_Resampler"):
                x = fractional_resample(x, fs_in, fs_out)
            else:
                x = direct_resample(x, fs_in, fs_out)
        return x

    @property
    def is_passthrough(self) -> bool:
        return (self.if_freq_hz == 0.0
                and abs(self.source_fs_hz - self.internal_fs_hz) < 1e-6
                and self.filter_impl not in ("Fir_Filter",
                                             "Freq_Xlating_Fir_Filter"))


_SINGLE_STREAM_REJECT = {
    # native blocks that cannot ride the single-stream conf chain: the
    # beamformer consumes an [N, n_antennas] array (the reference feeds it
    # from the 8-port Raw_Array hardware source) — use
    # condition.Beamformer on multi-channel captures directly
    "Beamformer_Filter",
}


def build_frontend(conf: InMemoryConfiguration) -> FrontEnd:
    """Realize SignalConditioner/DataTypeAdapter/InputFilter/Resampler conf
    keys (conf/gnss-sdr_GPS_L1_ishort.conf conventions) as a FrontEnd."""
    internal = float(conf.property(
        "GNSS-SDR.internal_fs_sps",
        conf.property("GNSS-SDR.internal_fs_hz", 4_000_000.0)))
    source = float(conf.property("SignalSource.sampling_frequency", internal))
    # the reference's xlating filter reads InputFilter.IF; some confs name
    # it SignalSource.freq_IF
    if_freq = float(conf.property(
        "InputFilter.IF", conf.property("SignalSource.freq_IF", 0.0)))
    filt = str(conf.property("InputFilter.implementation", "Pass_Through"))
    if filt in _SINGLE_STREAM_REJECT:
        raise ValueError(
            f"InputFilter '{filt}' consumes a multi-antenna array, not the "
            "single-stream conf chain; apply condition.Beamformer to the "
            "multi-channel capture before the receiver")
    return FrontEnd(
        source_fs_hz=source,
        internal_fs_hz=internal,
        if_freq_hz=if_freq,
        filter_impl=filt,
        resampler_impl=str(conf.property("Resampler.implementation",
                                         "Pass_Through")),
        n_taps=int(conf.property("InputFilter.number_of_taps", 65)),
    )


# the signal groups this port carries (those the receiver has a decoder
# for)
PORTED_SIGNALS = tuple(_DECODERS)


def to_receiver_config(conf: InMemoryConfiguration,
                       signal_id: str | None = None) -> ReceiverConfig:
    """Map reference property names (conf/gnss-sdr_GPS_L1_ishort.conf
    conventions) onto a ReceiverConfig for ONE channel group.

    `signal_id` selects the group in multi-constellation confs (default:
    the first configured group).  The Acquisition_XX/Tracking_XX
    `implementation=` names are routed through runtime.factory: an unknown
    name raises KeyError (the reference factory logs 'Block ... not found'
    and aborts the flowgraph), a hardware block raises ValueError, and a
    strategy, signal or positioning mode this port does not carry raises
    NotImplementedError naming its ROADMAP.md item."""
    from . import factory

    groups = conf_signal_groups(conf)
    if signal_id is None:
        signal_id = groups[0]
    for sid in groups:
        if sid not in PORTED_SIGNALS:
            raise not_ported(f"signal '{sid}'", "signals")
    fs = conf.property("GNSS-SDR.internal_fs_sps",
                       conf.property("GNSS-SDR.internal_fs_hz", 4_000_000.0))
    sig = f"_{signal_id}"
    acq_impl = str(conf.property(f"Acquisition{sig}.implementation", ""))
    acq_strategy = "pcps"
    if acq_impl:
        info = factory.resolve(acq_impl)
        if info.status == "hardware":
            raise ValueError(
                f"acquisition '{acq_impl}' needs hardware this build does "
                f"not drive ({info.note})")
        acq_strategy = info.strategy or "pcps"
        if acq_strategy == "assisted":
            raise not_ported(
                f"acquisition '{acq_impl}' (strategy '{acq_strategy}')",
                "assistance")
    trk_impl = str(conf.property(f"Tracking{sig}.implementation", ""))
    track_engine = "dll_pll"
    if trk_impl:
        tinfo = factory.resolve(trk_impl)
        if tinfo.status == "hardware":
            raise ValueError(
                f"tracking '{trk_impl}' needs an external process/device "
                f"({tinfo.note})")
        if tinfo.strategy == "tcp_connector":
            # native but standalone: one TCP round-trip per epoch cannot
            # live inside the batched capture loop — use
            # track.tcp_connector.TcpConnectorTracking directly (the
            # reference runs this block per-channel against an external
            # MATLAB/Simulink process, gps_l1_ca_tcp_connector_tracking.cc)
            raise ValueError(
                f"tracking '{trk_impl}' closes its loop over TCP per epoch; "
                "run it standalone via gnss_sdr_1_tpu_torch.track."
                "tcp_connector, not inside the batched Receiver")
        if tinfo.strategy not in ("dll_pll", "veml", "kf"):
            raise not_ported(
                f"tracking '{trk_impl}' (strategy '{tinfo.strategy}')",
                "signals")
        # VEML is the DLL/PLL engine at 5 taps (the receiver picks the
        # taps by signal)
        track_engine = "kf" if tinfo.strategy == "kf" else "dll_pll"
    positioning_mode = str(conf.property("PVT.positioning_mode", "Single"))
    if positioning_mode != "Single":
        raise not_ported(f"PVT.positioning_mode={positioning_mode}",
                         "ppp_rtk")
    n_channels = int(conf.property(f"Channels{sig}.count",
                                   conf.property("Channels.count", 8)))
    # per-channel satellite pinning (ChannelN.satellite, read by the
    # flowgraph at gnss_flowgraph.cc:1076-1090)
    pins = tuple(
        int(conf.property(f"Channel{ch}.satellite", 0)) or None
        for ch in range(n_channels)
    )
    return ReceiverConfig(
        fs_hz=float(fs),
        signal_id=signal_id,
        n_channels=int(n_channels),
        doppler_max_hz=float(conf.property(f"Acquisition{sig}.doppler_max", 5000.0)),
        doppler_step_hz=float(conf.property(f"Acquisition{sig}.doppler_step", 250.0)),
        acq_threshold=float(conf.property(f"Acquisition{sig}.threshold", 2.0)),
        acq_use_cfar=conf.property(f"Acquisition{sig}.use_CFAR_algorithm", False),
        acq_dwells=int(conf.property(f"Acquisition{sig}.max_dwells", 2)),
        acq_strategy=acq_strategy,
        acq_tong=acq_strategy == "tong",
        # the Tong counters (pcps_tong_acquisition_cc tong_init_val /
        # tong_max_val) and the QuickSync folding factor
        tong_init=int(conf.property(f"Acquisition{sig}.tong_init_val", 2)),
        tong_max=int(conf.property(f"Acquisition{sig}.tong_max_val", 10)),
        acq_folding_factor=int(conf.property(
            f"Acquisition{sig}.folding_factor", 2)),
        track_engine=track_engine,
        correlator=str(conf.property(f"Tracking{sig}.correlator", "auto")),
        pll_bw_hz=float(conf.property(f"Tracking{sig}.pll_bw_hz", 25.0)),
        dll_bw_hz=float(conf.property(f"Tracking{sig}.dll_bw_hz", 2.0)),
        pll_bw_narrow_hz=float(
            conf.property(f"Tracking{sig}.pll_bw_narrow_hz", 12.0)),
        dll_bw_narrow_hz=float(
            conf.property(f"Tracking{sig}.dll_bw_narrow_hz", 0.75)),
        extend_correlation_symbols=int(conf.property(
            f"Tracking{sig}.extend_correlation_symbols",
            20 if signal_id == "1C" else 0)),
        early_late_space_chips=float(conf.property(
            f"Tracking{sig}.early_late_space_chips", 0.5)),
        enable_fll_pull_in=bool(conf.property(f"Tracking{sig}.enable_fll_pull_in", False)),
        channel_satellites=pins,
        # PVT corrections: the reference's PVT.iono_model/trop_model
        # (rtklib_pvt.cc config keys; values Broadcast_Klobuchar/OFF and
        # Saastamoinen/OFF) and PVT.elevation_mask
        iono_model=("off" if str(conf.property("PVT.iono_model",
                    "Broadcast_Klobuchar")).upper() == "OFF" else "broadcast"),
        trop_model=("saastamoinen" if str(conf.property(
            "PVT.trop_model", "OFF")).lower().startswith("saas") else "off"),
        elevation_mask_deg=float(conf.property("PVT.elevation_mask", 5.0)),
        positioning_mode=positioning_mode,
        # PVT.output_rate_ms (rtklib_pvt_gs output cadence); 0 = every tick
        pvt_output_rate_ms=int(conf.property("PVT.output_rate_ms", 0)),
        # monitor taps (GNSS-SDR.enable_monitor + Monitor.*, PVT.enable_
        # monitor — gnss_flowgraph.cc:680, rtklib_pvt.cc monitor config)
        enable_monitor=bool(conf.property("GNSS-SDR.enable_monitor", False)),
        monitor_host=str(conf.property("Monitor.client_addresses",
                                       "127.0.0.1")).split("_")[0],
        monitor_port=int(conf.property("Monitor.udp_port", 1234)),
        monitor_decimation=int(conf.property("Monitor.decimation_factor",
                                             50)),
        enable_pvt_monitor=bool(conf.property("PVT.enable_monitor", False)),
        pvt_monitor_port=int(conf.property("PVT.monitor_udp_port", 1111)),
    )


def to_receiver_configs(conf: InMemoryConfiguration) -> list[ReceiverConfig]:
    """One ReceiverConfig per configured channel group — the
    multi-constellation conf contract (Channels_1C.count=8 +
    Channels_1B.count=8 run GPS L1 and Galileo E1 groups concurrently with
    one mixed PVT, gnss_flowgraph.cc:1722 set_signals_list)."""
    return [to_receiver_config(conf, sid) for sid in conf_signal_groups(conf)]
