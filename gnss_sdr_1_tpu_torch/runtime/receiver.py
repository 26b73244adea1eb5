"""Segment-synchronous GPS L1 C/A, L2C and L5, Galileo E1B and E5a,
GLONASS L1/L2 C/A and BeiDou B1I/B3I receiver pipeline.

Reference parity: ControlThread::run (control_thread.cc:239) +
GNSSFlowgraph channel management (gnss_flowgraph.cc:1058-1104): satellite
search list, acquisition -> channel assignment, tracking supervision with
satellite recycling, telemetry/observables/PVT fan-in.  The data plane runs
on the card (batched PCPS on torch.fft, the chunked tracking engine with
its CUDA chain kernel, or the gather walk); the lifecycle FSM stays on
the host between capture segments.

This package carries GPS L1 C/A ('1C', LNAV), GPS L2CM ('2S': the 20 ms
code is the CNAV symbol), GPS L5I ('L5': NH10 secondary, CNAV), Galileo
E1B ('1B': the sinBOC(1,1) replica, 5-tap VEML tracking, I/NAV), Galileo
E5a-I ('5X': CS20 secondary, F/NAV), GLONASS L1/L2 C/A ('1G'/'2G':
each slot's FDMA carrier offset `fdma_k` folded into its acquisition
replica and carried as the channel's NCO bias, GNAV) and BeiDou B1I/B3I
('B1'/'B3': NH20 secondary and D1 NAV on MEO/IGSO, D2 NAV on the GEO
PRNs 1-5, CGCS2000 orbits) with PCPS, Tong,
QuickSync, CCCWSR, fine-Doppler, 8 ms or (on E5a) the noncoherent I/Q CAF
acquisition (the strategy dispatch of gnss_block_factory.cc:1552-1709),
and either the DLL/PLL engine (chunked, the default, or the per-epoch
exact gather path, `correlator="gather"`: one gather_block launch per
capture segment on the card) or the Kalman-filter tracker
(`track_engine="kf"`, track.kf: one kf_block launch per capture segment
on the card; Galileo E1B in the virtual half-chip basis, and a GLONASS
channel at the nominal carrier, as the JAX receiver builds it).  On L5,
E5a, B1I and B3I the
chain wipes the secondary code in the loop once telemetry reports
secondary sync (`_maybe_extend`; a GEO channel never reports it and stays
in wide tracking).  One Receiver runs one signal group; MultiReceiver
(runtime/multi_receiver.py) joins several.  `process` takes a whole
capture; `process_stream` takes blocks as they arrive (complex64, or raw
integer items shipped to the card as they are and unpacked there), with
each segment's readback overlapping the next segment's launch;
`checkpoint` / `resume_from` carry a run across processes and devices;
the monitor taps stream Gnss_Synchro records and PVT fixes over UDP, and
the telecommand interface (runtime.telecommand) drives `status`,
`standby`, `reset` and the cold/warm/hot starts.  Assistance is not
ported yet: ReceiverConfig refuses it, naming the ROADMAP.md item that
ports it.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from .. import resolve_device
from ..acquire import (AcqConfig, CafAcquisition, CccwsrAcquisition,
                       FineDopplerAcquisition, Pcps8msAcquisition,
                       PcpsAcquisition, QuickSyncAcquisition)
from ..codes import (NH10, galileo_e1_sinboc11, galileo_e1c_code,
                     galileo_e5aq_code, resample_code, tracking_replica)
from ..codes.galileo_e5 import galileo_e5ai_secondary
from ..condition.filters import to_device
from ..constants import (SIGNALS, SPEED_OF_LIGHT_M_S, SignalSpec,
                         glonass_fdma_offset_hz)
from ..io.formats import FORMATS, convert_to_complex64
from ..observables import (CarrierSmoother, ChannelEpochHistory,
                           compute_observables)
from ..pvt.geodesy import llh_to_ecef
from ..pvt.solver import PvtSolution, solve_pvt
from ..telemetry.channel_adapters import (BeidouChannelDecoder,
                                          GalileoChannelDecoder,
                                          GalileoE5aChannelDecoder,
                                          GlonassChannelDecoder,
                                          GpsL2ChannelDecoder,
                                          GpsL5ChannelDecoder)
from ..telemetry.decoder import LnavDecoder
from ..track import TrackConfig, TrackingEngine, TrackOutputs
from ..track.engine import (state_from_numpy, state_to_numpy,
                            tracking_correlator)
from ..track.kf import KfTrackConfig, KfTrackingEngine
from .monitor import GnssSynchro, UdpSink
from .stream import STREAM_FORMATS, PinnedStaging, unpack_raw

log = logging.getLogger("gnss_sdr_1_tpu_torch.receiver")


@dataclasses.dataclass
class ReceiverConfig:
    fs_hz: float = 4_000_000.0
    signal_id: str = "1C"
    n_channels: int = 8
    prn_search: tuple[int, ...] = tuple(range(1, 33))
    # acquisition
    doppler_max_hz: float = 5000.0
    doppler_step_hz: float = 250.0
    acq_threshold: float = 2.0
    acq_use_cfar: bool = False
    acq_dwells: int = 2
    acq_two_steps: bool = True
    acq_bit_transition: bool = False
    acq_tong: bool = False           # Tong sequential detector
    tong_init: int = 2
    tong_max: int = 10
    # acquisition strategy from the conf implementation= name, routed
    # through runtime.factory (gnss_block_factory.cc:1552-1709):
    # pcps | tong | quicksync | cccwsr | fine_doppler | 8ms | caf
    acq_strategy: str = "pcps"
    # QuickSync folding factor (Acquisition_XX.folding_factor)
    acq_folding_factor: int = 2
    # tracking engine from Tracking_1C.implementation: dll_pll | kf
    # (GPS_L1_CA_KF_Tracking -> track.kf.KfTrackingEngine)
    track_engine: str = "dll_pll"
    # DLL/PLL correlator (Tracking_XX.correlator conf key): auto | chunked
    # | gather.  'auto' is 'chunked', the accelerator path, as the JAX
    # package's 'auto' is its chunked Pallas path on its accelerator; the
    # JAX names 'pallas' and 'mxu' are 'chunked' here; 'gather' is the
    # per-epoch exact path (the JAX package's choice off the TPU)
    correlator: str = "auto"
    doppler_step2_hz: float = 40.0
    num_doppler_bins_step2: int = 10
    # tracking
    pll_bw_hz: float = 25.0
    dll_bw_hz: float = 2.0
    pll_bw_narrow_hz: float = 12.0
    dll_bw_narrow_hz: float = 0.75
    # states 3/4: coherent extension once telemetry reports bit sync
    # (dll_pll_veml_tracking.cc:1774-1900); 0 disables the switch
    extend_correlation_symbols: int = 20
    enable_fll_pull_in: bool = False
    pull_in_time_s: float = 0.3
    early_late_space_chips: float = 0.5
    very_early_late_space_chips: float = 0.6
    # epochs per chunk of the tracking engine (one chain launch each)
    chunk_epochs: int = 16
    # per-channel satellite pinning (ChannelN.satellite=PRN,
    # gnss_flowgraph.cc:1076-1090); empty = dynamic
    channel_satellites: tuple = ()
    # GLONASS FDMA frequency channel per slot: ((slot, k), ...), k in
    # [-7, 6]; slots not listed run at k = 0
    fdma_k: tuple = ()
    # pipeline
    block_ms: int = 40
    obs_interval_ms: int = 20
    # PVT.output_rate_ms: solve at this rate while observables keep forming
    # at obs_interval_ms; 0 -> solve at every observables tick
    pvt_output_rate_ms: int = 0
    reacq_interval_blocks: int = 25
    iono_model: str = "broadcast"    # 'off' | 'broadcast' (Klobuchar)
    trop_model: str = "off"          # 'off' | 'saastamoinen'
    elevation_mask_deg: float = 5.0
    pvt_weighted: bool = True
    # Hatch carrier-smoothing window in observable epochs (0 disables)
    carrier_smoothing_epochs: int = 25
    raim: bool = True
    raim_sigma_m: float = 2.5
    positioning_mode: str = "Single"
    # monitoring taps (GNSS-SDR.enable_monitor + Monitor.* props;
    # gnss_flowgraph.cc:680 monitor wiring, gnss_synchro_monitor decimation)
    enable_monitor: bool = False
    monitor_host: str = "127.0.0.1"
    monitor_port: int = 1234
    monitor_decimation: int = 50
    enable_pvt_monitor: bool = False
    pvt_monitor_port: int = 1111
    # telemetry watchdog: release a channel after this many symbols without
    # a decoded TOW (gps_l1_ca_telemetry_decoder_gs.cc:364); 0 disables
    watchdog_symbols: int = 45000
    # symbol-grid capture reduction once every active channel is bit-synced
    # ('auto'); 'off' keeps the decimated per-epoch outputs
    symbol_readback: str = "auto"

    def __post_init__(self) -> None:
        from .config import not_ported

        # what each unported value waits for (runtime.config.ROADMAP_ITEMS)
        refused = {
            "signal_id": (self.signal_id, tuple(_DECODERS), "signals"),
            "acq_strategy": (self.acq_strategy, _ACQ_STRATEGIES,
                             "assistance" if self.acq_strategy == "assisted"
                             else "signals"),
            "positioning_mode": (self.positioning_mode, ("Single",),
                                 "ppp_rtk"),
        }
        for name, (got, only, item) in refused.items():
            if got not in only:
                raise not_ported(f"{name}={got!r}", item)
        if self.track_engine not in ("dll_pll", "kf"):
            raise NotImplementedError(
                f"track_engine={self.track_engine!r} is not ported yet "
                f"(only 'dll_pll', 'kf')")
        tracking_correlator(self.correlator)

    @property
    def spec(self) -> SignalSpec:
        return SIGNALS[self.signal_id]


# acquisition strategies this package carries ('caf' is the E5a strategy;
# 'assisted' needs the assistance sources)
_ACQ_STRATEGIES = ("pcps", "tong", "quicksync", "cccwsr", "fine_doppler",
                   "8ms", "caf")


class Receiver:
    """Single-constellation single-band receiver (GPS L1 C/A, L2C and L5,
    Galileo E1B and E5a, GLONASS L1/L2 C/A, BeiDou B1I/B3I).

    `device`: None runs the data plane on the card (and raises without
    one); the CPU only when asked for (`device="cpu"`)."""

    def __init__(self, cfg: ReceiverConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        spec = cfg.spec
        fs = cfg.fs_hz
        self.samples_per_code = int(round(fs * spec.code_period_s))
        # the replica carries any BOC subcarrier (Galileo E1: sinBOC(1,1))
        replicas = {p: tracking_replica(cfg.signal_id, p)
                    for p in cfg.prn_search}
        self._codes = {p: r[0] for p, r in replicas.items()}
        virtual_rate, spc_code = next(iter(replicas.values()))[1:]
        is_veml = cfg.signal_id == "1B"
        # FDMA slot carrier offsets (GLONASS): per-PRN replica modulation in
        # acquisition + per-channel NCO bias in tracking
        self._fdma_offsets = {
            prn: glonass_fdma_offset_hz(cfg.signal_id, k)
            for prn, k in dict(cfg.fdma_k).items()
        } if cfg.fdma_k else {}
        # an FDMA offset that is not a whole number of carrier cycles per
        # one-period window (k * 562.5 kHz * 1 ms: half-integer for odd k)
        # leaves a phase jump at the circular-correlation wrap and splits
        # the peak into +-500 Hz sidebands; a secondary code or a symbol as
        # short as the code (E1B 4 ms, L2CM 20 ms) can flip the sign at
        # every code-period boundary and smear the one-period correlation.
        # The reference's cure for both is the two-period window
        # (pcps_acquisition.cc set_local_code :239-273)
        acq_bit_transition = (
            cfg.acq_bit_transition
            or any(abs(f) % (fs / self.samples_per_code) > 1e-6
                   for f in self._fdma_offsets.values())
            or spec.secondary_code_length > 0
            or spec.chips_per_symbol <= spec.code_length_chips)
        acq_cfg = AcqConfig(
            fs_hz=fs,
            samples_per_code=self.samples_per_code,
            samples_per_chip=max(1, int(round(fs / spec.code_rate_chips_s))),
            doppler_max_hz=cfg.doppler_max_hz,
            doppler_step_hz=cfg.doppler_step_hz,
            max_dwells=cfg.acq_dwells,
            bit_transition_flag=acq_bit_transition,
            use_cfar=cfg.acq_use_cfar,
            threshold=cfg.acq_threshold,
            make_two_steps=cfg.acq_two_steps,
            doppler_step2_hz=cfg.doppler_step2_hz,
            num_doppler_bins_step2=cfg.num_doppler_bins_step2,
        )
        fs_code_rate = (virtual_rate, spec.code_length_chips * spc_code)
        self.acq = PcpsAcquisition(acq_cfg, self._codes,
                                   fs_code_rate=fs_code_rate,
                                   freq_offsets_by_prn=self._fdma_offsets,
                                   device=self.device)
        self.acq_strategy = strat = (
            "tong" if cfg.acq_tong and cfg.acq_strategy == "pcps"
            else cfg.acq_strategy)
        self._acq_tong = strat == "tong"
        self._make_acquisition(strat, acq_cfg, fs_code_rate, virtual_rate)
        # bit / secondary-code period in epochs — the coherent-extension
        # alignment grid (20 ms GPS bit, NH10 on L5, CS20 on E5a, NH20 on
        # B1I/B3I); an E1B or L2CM symbol is one epoch and GLONASS has no
        # secondary code, so those signals have neither extension nor the
        # symbol-grid readback
        self._sec_period = {"1C": 20, "L5": 10, "5X": 20, "B1": 20,
                            "B3": 20}.get(cfg.signal_id)
        # in-loop secondary wipe-off tables (dll_pll_veml_tracking.cc:549-660
        # start_tracking secondary setup), one row per slot: NH10 for GPS
        # L5I, CS20 for Galileo E5a-I, NH20 for BeiDou B1I/B3I D1 — all
        # data-carrying, so the Costas discriminator stays active
        # (sec_data).  GEO (D2) slots get the NH20 row too; their decoder
        # never reports secondary sync, so it is never switched on
        sec_code = {"L5": NH10, "5X": galileo_e5ai_secondary(),
                    "B1": BeidouChannelDecoder._NH_AMP,
                    "B3": BeidouChannelDecoder._NH_AMP}.get(cfg.signal_id)
        sec_codes = None if sec_code is None else np.tile(
            np.asarray(sec_code, dtype=np.float32), (len(self.acq.prns), 1))
        # tracking engine from Tracking_XX.implementation: the chunked
        # DLL/PLL engine, or the Kalman carrier tracker
        # (gps_l1_ca_kf_tracking_cc.h:76 — a drop-in channel tracking
        # implementation producing the same outputs)
        self.trk_kind = cfg.track_engine
        self.correlator = tracking_correlator(cfg.correlator)
        codes = np.stack([self._codes[p] for p in self.acq.prns])
        if self.trk_kind == "kf":
            self.trk = KfTrackingEngine(
                KfTrackConfig(
                    fs_hz=fs,
                    code_length_chips=spec.code_length_chips * spc_code,
                    chip_rate_chips_s=virtual_rate,
                    carrier_freq_hz=spec.carrier_freq_hz,
                    n_channels=cfg.n_channels,
                    dll_bw_hz=cfg.dll_bw_hz,
                    early_late_space_chips=(
                        cfg.early_late_space_chips * spc_code),
                ),
                codes, device=self.device)
        else:
            self.trk = TrackingEngine(
                TrackConfig(
                    fs_hz=fs,
                    code_length_chips=spec.code_length_chips,
                    chip_rate_chips_s=spec.code_rate_chips_s,
                    carrier_freq_hz=spec.carrier_freq_hz,
                    n_channels=cfg.n_channels,
                    code_samples_per_chip=spc_code,
                    veml=is_veml,
                    pll_bw_hz=cfg.pll_bw_hz,
                    dll_bw_hz=cfg.dll_bw_hz,
                    pll_bw_narrow_hz=cfg.pll_bw_narrow_hz,
                    dll_bw_narrow_hz=cfg.dll_bw_narrow_hz,
                    extend_correlation_symbols=max(1, min(
                        cfg.extend_correlation_symbols,
                        self._sec_period or 10 ** 9)),
                    enable_fll_pull_in=cfg.enable_fll_pull_in,
                    pull_in_time_s=cfg.pull_in_time_s,
                    # the reference's E1 VEML E/L spacing
                    early_late_space_chips=(
                        0.15 if is_veml else cfg.early_late_space_chips),
                    very_early_late_space_chips=(
                        cfg.very_early_late_space_chips),
                    chunk_epochs=cfg.chunk_epochs,
                    sec_data=sec_codes is not None,
                    correlator=self.correlator,
                ),
                codes, sec_codes=sec_codes, device=self.device)
        self._slot_of_prn = {p: i for i, p in enumerate(self.acq.prns)}

        self.state = self.trk.init_state()
        self.channel_prn: list[int | None] = [None] * cfg.n_channels
        # host shadow of state.mode (host-written only; see _maybe_extend)
        self._mode_host = np.zeros(cfg.n_channels, dtype=np.int32)
        # consecutive acquisitions that assigned nothing while channels
        # were idle (caps the pull-in segment gating when channels
        # outnumber visible satellites); any channel release resets it
        self._empty_acq_streak = 0
        self.decoders: dict[int, LnavDecoder] = {}
        self.histories: dict[int, ChannelEpochHistory] = {}
        self.sym_count: dict[int, int] = {}
        self.last_rem: dict[int, float] = {}
        self.last_frac: dict[int, float] = {}
        self.carrier_phase_acc: dict[int, float] = {}
        self.last_carr_rem: dict[int, float] = {}
        self._ledger_prev_start: dict[int, float] = {}
        self.rx_tow_s: float | None = None
        self.rx_tow_sample: int | None = None
        self.solutions: list[PvtSolution] = []
        self.obs_epochs: list[tuple[float, dict]] = []
        self._pos = 0          # call-relative index of the next segment
        # absolute sample index of the next call's first sample: stamps
        # continue across process() / process_stream() calls, so a resumed
        # receiver keeps one RX-clock timeline
        self._abs_base = 0
        self._standby = False
        self._blocks_done = 0
        self._next_obs_sample = None
        self._no_tow_syms: dict[int, int] = {}
        self.watchdog_trips = 0
        self._acq_info: dict[int, tuple] = {}
        self._samples_dev = None
        self._ingest_scale = None
        # symbol-readback carry: prn -> [sum_of_means, pending_epochs,
        # phase_in_symbol, start_of_first_pending] (see _harvest_symbols)
        self._sym_carry: dict[int, list] = {}
        self._smoother = None
        if cfg.carrier_smoothing_epochs > 0:
            self._smoother = CarrierSmoother(
                window=cfg.carrier_smoothing_epochs,
                wavelength_m=SPEED_OF_LIGHT_M_S / spec.carrier_freq_hz)
        self.monitor = None
        self.pvt_monitor = None
        if cfg.enable_monitor:
            self.monitor = UdpSink(cfg.monitor_host, cfg.monitor_port,
                                   decimation=1)
        if cfg.enable_pvt_monitor:
            self.pvt_monitor = UdpSink(cfg.monitor_host, cfg.pvt_monitor_port)

    def _make_acquisition(self, strat: str, acq_cfg: AcqConfig,
                          fs_code_rate, virtual_rate: float) -> None:
        """The strategy's acquisition object in place of the PCPS one
        (conf implementation= names routed through runtime.factory;
        gnss_block_factory.cc:1552-1709)."""
        cfg, fs, dev = self.cfg, self.cfg.fs_hz, self.device
        if strat in ("cccwsr", "8ms") and cfg.signal_id != "1B":
            raise ValueError(f"{strat} acquisition is a Galileo E1 strategy")
        if strat == "caf" and cfg.signal_id != "5X":
            raise ValueError("noncoherent-IQ CAF acquisition is a Galileo "
                             "E5a strategy")

        def sampled(codes):
            return {p: resample_code(np.asarray(codes[p], np.float32), fs,
                                     virtual_rate, self.samples_per_code)
                    for p in cfg.prn_search}

        if strat == "fine_doppler":
            self.acq = FineDopplerAcquisition(self.acq)
        elif strat == "quicksync":
            self.acq = QuickSyncAcquisition(
                acq_cfg, self._codes, folding_factor=cfg.acq_folding_factor,
                fs_code_rate=fs_code_rate, device=dev)
        elif strat == "cccwsr":
            # data (E1B) and pilot (E1C) components, both sinBOC(1,1)
            pilots = {p: galileo_e1_sinboc11(galileo_e1c_code(p))
                      for p in cfg.prn_search}
            self.acq = CccwsrAcquisition(acq_cfg, sampled(self._codes),
                                         sampled(pilots), device=dev)
        elif strat == "8ms":
            self.acq = Pcps8msAcquisition(
                dataclasses.replace(acq_cfg, sampled_ms=2),
                sampled(self._codes), device=dev)
        elif strat == "caf":
            # data (E5a-I) and pilot (E5a-Q) codes at 10.23 Mcps, the CAF
            # window eight Doppler steps wide
            pilots = {p: resample_code(
                np.asarray(galileo_e5aq_code(p), np.float32), fs, 10.23e6,
                self.samples_per_code) for p in cfg.prn_search}
            self.acq = CafAcquisition(
                acq_cfg, sampled(self._codes), pilots,
                caf_window_hz=8.0 * cfg.doppler_step_hz, device=dev)

    # ---------------- channel lifecycle ----------------

    def _acquire_and_assign(self, samples_abs_offset: int,
                            samples: np.ndarray) -> None:
        """Run acquisition on idle PRNs, assign positives to idle channels
        (gnss_flowgraph.cc apply_action satellite recycling analogue)."""
        idle_channels = [c for c, p in enumerate(self.channel_prn)
                         if p is None]
        if not idle_channels:
            return
        assigned: list[tuple[int, int]] = []
        if self._acq_tong:
            res = self.acq.acquire_tong(
                samples, tong_init=self.cfg.tong_init,
                tong_max=self.cfg.tong_max, samplestamp=samples_abs_offset)
        else:
            res = self.acq.acquire(samples, samplestamp=samples_abs_offset)
        tracked = {p for p in self.channel_prn if p is not None}
        pins = self.cfg.channel_satellites
        order = np.argsort(-res.test_stat)
        dops = np.array(res.doppler_hz, dtype=np.float64)
        for k in order:
            prn = self.acq.prns[k]
            if not res.positive[k] or prn in tracked:
                continue
            if not idle_channels:
                break
            # pinned channels only accept their satellite, and get it
            # preferentially (ChannelN.satellite, gnss_flowgraph.cc:1076)
            ch = next((c for c in idle_channels
                       if c < len(pins) and pins[c] == prn), None)
            if ch is None:
                ch = next((c for c in idle_channels
                           if c >= len(pins) or pins[c] is None), None)
            if ch is None:
                continue
            idle_channels.remove(ch)
            self.channel_prn[ch] = prn
            # the KF seeds its Doppler prior from the acq grid step
            # (gps_l1_ca_kf_tracking_cc.cc:276-279); the DLL/PLL engine
            # carries the slot's FDMA offset as a constant NCO bias
            extra = ({"doppler_step_hz": self.cfg.doppler_step_hz}
                     if self.trk_kind == "kf" else
                     {"carr_offset_hz": self._fdma_offsets.get(prn, 0.0)})
            self.state = self.trk.activate_channel(
                self.state, ch, self._slot_of_prn[prn],
                float(res.delay_samples[k]), float(dops[k]),
                samples_abs_offset, self._pos, **extra)
            # telemetry decoders per signal: LNAV (1C), CNAV (2S, L5),
            # I/NAV (1B), F/NAV (5X), GNAV (1G, 2G)
            self.decoders[prn] = _DECODERS[self.cfg.signal_id](prn)
            self._mode_host[ch] = 0
            self.histories[prn] = ChannelEpochHistory()
            self.sym_count[prn] = 0
            assigned.append((ch, prn))
            self.carrier_phase_acc.pop(prn, None)
            self.last_carr_rem.pop(prn, None)
            self._ledger_prev_start.pop(prn, None)
            self._no_tow_syms[prn] = 0
            self._acq_info[prn] = (float(res.delay_samples[k]),
                                   float(dops[k]), int(res.samplestamp))
            log.info("ch %d <- PRN %d (delay %.1f, doppler %.0f, stat %.1f)",
                     ch, prn, res.delay_samples[k], dops[k],
                     res.test_stat[k])
        if assigned:
            self._empty_acq_streak = 0
            # fractional code phase at each new channel's first epoch start
            # (sub-sample pseudorange resolution) — one readback per batch
            rems = self.state.rem_code_phase_samples.cpu().numpy()
            for ch, prn in assigned:
                self.last_rem[prn] = float(rems[ch])
                self.last_frac[prn] = self.last_rem[prn]
        else:
            self._empty_acq_streak += 1

    def _release(self, ch: int, prn: int, why: str) -> None:
        log.info("ch %d PRN %d %s — releasing", ch, prn, why)
        self.channel_prn[ch] = None
        self._empty_acq_streak = 0

    def _watchdog(self, ch: int, prn: int, dec, n_new: int) -> bool:
        """Telemetry watchdog: no decoded TOW for watchdog_symbols epochs
        recycles the satellite (gps_l1_ca_telemetry_decoder_gs.cc:364).
        Returns True when the channel was released."""
        wd = self.cfg.watchdog_symbols
        if dec is None or wd <= 0:
            return False
        if dec.tow_at_symbol(self.sym_count[prn] - 1) is not None:
            self._no_tow_syms[prn] = 0
            return False
        self._no_tow_syms[prn] = self._no_tow_syms.get(prn, 0) + n_new
        if self._no_tow_syms[prn] <= wd:
            return False
        self.state = self.trk.deactivate_channel(self.state, ch)
        self._release(ch, prn, f"telemetry watchdog "
                      f"({self._no_tow_syms[prn]} symbols, no frame)")
        self._no_tow_syms[prn] = 0
        self.watchdog_trips += 1
        return True

    def _harvest(self, outs, block_offset_abs: int, decim: int = 1,
                 owners=None) -> None:
        """Stream tracking epochs into telemetry decoders + histories.

        `decim` > 1: the loop-state fields (rem_carr/doppler/cn0) of `outs`
        are exact only at epochs k % decim == decim-1 (engine
        capture_decim); prompts/starts stay full-rate for telemetry, and
        observables history points land on the decimated grid.  `owners`
        (process_stream): each channel's (PRN, decoder) when the segment
        was launched; a channel assigned anew since then is skipped, its
        rows being its previous occupant's."""
        valid = outs.valid                        # [E, C]
        starts = outs.start
        corr = outs.correlators                   # [E, C, K] complex
        dops = outs.carrier_doppler_hz
        lens = outs.cur_len
        cn0s = outs.cn0_dbhz
        active = outs.active
        p_idx = getattr(self.trk.cfg, "prompt_index", 1)
        for ch, prn in enumerate(self.channel_prn):
            if prn is None or (owners is not None and (
                    owners[ch][0] != prn
                    or owners[ch][1] is not self.decoders.get(prn))):
                continue
            v = valid[:, ch]
            if not v.any():
                if not bool(active[-1, ch]):
                    self._release(ch, prn, "lost lock")
                continue
            # leaving symbol mode: complete the decoder's epoch stream first
            if self._sym_carry.get(prn, (0.0, 0))[1]:
                self._flush_sym_carry(prn)
            prompts = corr[v, ch, p_idx]
            ep_starts = starts[v, ch].astype(np.int64) + block_offset_abs
            ep_dops = dops[v, ch]
            # code-period boundary = integer start + fractional code phase
            # AT that start (the device outputs rem at the NEXT start, so
            # shift by one epoch, carrying across segments).  The device
            # wraps rem into [0,1) and realizes the floor in the NEXT epoch
            # length (A.6): reconstruct the pre-floor fraction
            # frac_j = rem_j - round(rem_j - rem_{j-1}) (the true drift is
            # << 0.5 sample/epoch), which pairs exactly with start_{j+1}.
            rems_next = np.asarray(outs.rem_code_phase_samples,
                                   dtype=np.float64)[v, ch]
            prev_rem = self.last_rem.get(prn, float(rems_next[0]))
            ext = np.concatenate([[prev_rem], rems_next])
            fracs = ext[1:] - np.round(np.diff(ext))
            rems_at = np.concatenate(
                [[self.last_frac.get(prn, prev_rem)], fracs[:-1]])
            if len(rems_next):
                self.last_rem[prn] = float(rems_next[-1])
                self.last_frac[prn] = float(fracs[-1])
            dec = self.decoders.get(prn)
            base_sym = self.sym_count[prn]
            # accumulated carrier phase = the device NCO ledger unwrapped in
            # host float64 (gnss_synchro.h:61-80 Carrier_phase_rads)
            ep_lens = lens[v, ch].astype(np.float64)
            rems_carr = np.asarray(outs.rem_carr_phase_rad,
                                   dtype=np.float64)[v, ch]
            ep_cn0 = cn0s[v, ch]
            nv = len(prompts)
            if decim <= 1:
                acc0 = self.carrier_phase_acc.get(prn, 0.0)
                prev_carr = self.last_carr_rem.get(
                    prn, float(rems_carr[0]) if len(rems_carr) else 0.0)
                # step applied between consecutive ledger values covers the
                # NEXT epoch (engine A.6 note): pair dopp_k with len_{k+1}
                lens_next = np.concatenate(
                    [ep_lens[1:], ep_lens[-1:]]) if len(ep_lens) else ep_lens
                est = (2.0 * np.pi * ep_dops.astype(np.float64)
                       * lens_next / self.cfg.fs_hz)
                prevs = np.concatenate(
                    [[prev_carr], rems_carr[:-1]]) if len(rems_carr) \
                    else rems_carr
                resid = rems_carr - prevs - est
                deltas = est + (np.mod(resid + np.pi, 2.0 * np.pi) - np.pi)
                acc_series = acc0 + np.cumsum(deltas)
                if len(acc_series):
                    self.carrier_phase_acc[prn] = float(acc_series[-1])
                    self.last_carr_rem[prn] = float(rems_carr[-1])
                if dec is not None:
                    dec.push(prompts.real, ep_starts)
                    hist = self.histories[prn]
                    for k in range(nv):
                        tow = dec.tow_at_symbol(base_sym + k)
                        if tow is not None:
                            hist.push(
                                float(ep_starts[k]) + float(rems_at[k]),
                                tow, float(ep_dops[k]),
                                float(acc_series[k]), float(ep_cn0[k]))
            else:
                # decimated grid: history/ledger points at valid epochs
                # m = decim, 2*decim, ... whose entering state is exact at
                # index m-1; `valid` is a prefix per segment (start strictly
                # increases), so valid-sequence indices == buffer indices
                D = decim
                push_m = np.arange(D, nv, D)
                acc = self.carrier_phase_acc.get(prn, 0.0)
                prev_carr = self.last_carr_rem.get(prn)
                prev_s = self._ledger_prev_start.get(prn)
                acc_series = np.zeros(len(push_m))
                for j, m in enumerate(push_m):
                    carr_m = float(rems_carr[m - 1])
                    dop_m = float(ep_dops[m - 1])
                    s_m = float(ep_starts[m])
                    if prev_s is not None and prev_carr is not None:
                        est = (2.0 * np.pi * dop_m * (s_m - prev_s)
                               / self.cfg.fs_hz)
                        resid = carr_m - prev_carr - est
                        acc += est + (np.mod(resid + np.pi, 2.0 * np.pi)
                                      - np.pi)
                    prev_s, prev_carr = s_m, carr_m
                    acc_series[j] = acc
                self.carrier_phase_acc[prn] = acc
                if prev_carr is not None:
                    self.last_carr_rem[prn] = prev_carr
                if prev_s is not None:
                    self._ledger_prev_start[prn] = prev_s
                if dec is not None:
                    dec.push(prompts.real, ep_starts)
                    hist = self.histories[prn]
                    for j, m in enumerate(push_m):
                        tow = dec.tow_at_symbol(base_sym + int(m))
                        if tow is not None:
                            hist.push(
                                float(ep_starts[m]) + float(rems_at[m]),
                                tow, float(ep_dops[m - 1]),
                                float(acc_series[j]),
                                float(ep_cn0[m - 1]))
                # monitor display series (held between grid points)
                if len(push_m):
                    idx = np.minimum(np.searchsorted(
                        push_m, np.arange(nv), side="right"),
                        len(push_m) - 1)
                    acc_series = acc_series[idx]
                else:
                    acc_series = np.zeros(nv)
            self.sym_count[prn] = base_sym + len(prompts)
            if self._watchdog(ch, prn, dec, len(prompts)):
                continue
            if self.monitor is not None and len(prompts):
                self._monitor_tap(ch, prn, prompts, ep_starts, ep_dops,
                                  ep_cn0, acc_series)
            if not bool(active[-1, ch]):
                self._release(ch, prn, "lost lock")

    # ---------------- symbol-grid harvest ----------

    def _pull_in_done(self) -> bool:
        """True once every active channel is through pull-in — the
        steady-state criterion that lets the capture loop use its full
        segment length: bit sync on GPS L1 C/A, secondary-code sync on L5,
        E5a, B1I and B3I (never on a GEO channel); an E1B decoder has no
        sync notion (a symbol is one epoch), so its channel counts as
        pulled in after 1,000 surviving epochs."""
        any_active = False
        for prn in self.channel_prn:
            if prn is None:
                continue
            any_active = True
            dec = self.decoders.get(prn)
            if dec is None:
                return False
            if hasattr(dec, "bit_offset") or hasattr(dec, "sec_sync_offset"):
                if getattr(dec, "bit_offset", None) is None \
                        and getattr(dec, "sec_sync_offset", None) is None:
                    return False
            elif self.sym_count.get(prn, 0) < 1000:
                return False
        return any_active

    def _symbol_offsets(self):
        """Per-channel symbol-boundary offsets (in [1, N]) for the
        symbol-grid capture reduction, or None while any active channel has
        no bit sync yet (and always for the KF tracker, and while a monitor
        taps the per-epoch series)."""
        if (self.cfg.symbol_readback != "auto" or self.trk_kind != "dll_pll"
                or self.cfg.signal_id != "1C" or self.monitor is not None):
            return None
        N = self._sec_period
        offs = np.full(self.cfg.n_channels, N, dtype=np.int32)
        any_active = False
        for ch, prn in enumerate(self.channel_prn):
            if prn is None:
                continue
            any_active = True
            dec = self.decoders.get(prn)
            bit0 = dec.bit_offset if dec is not None else None
            if bit0 is None:
                return None
            offs[ch] = ((bit0 - self.sym_count[prn] - 1) % N) + 1
        return offs if any_active else None

    def _flush_sym_carry(self, prn) -> None:
        """Emit a pending partial symbol before leaving symbol mode so the
        decoder's epoch indexing stays gap-free."""
        carry = self._sym_carry.get(prn)
        if not carry or carry[1] == 0:
            return
        dec = self.decoders.get(prn)
        if dec is not None:
            pend = carry[1]
            vals = np.full(pend, carry[0])
            st0 = int(carry[3] if carry[3] is not None else 0)
            sts = st0 + np.arange(pend, dtype=np.int64) * self.trk._t0_int
            dec.push(vals, sts)
        self._sym_carry[prn] = [0.0, 0, carry[2], None]

    def _harvest_symbols(self, souts, block_offset_abs: int,
                         sym_off) -> None:
        """Harvest a SymbolOutputs segment.

        Decoders receive one synthesized epoch batch per completed symbol
        (constant value = the symbol's prompt mean — bit-sign exact, since
        every epoch of a symbol carries the same bit); observables history
        points land on the symbol grid (20 ms), with the same entering-state
        pairing and ledger recursion as the decimated per-epoch path."""
        N = self._sec_period
        t0 = self.trk._t0_int
        fs = self.cfg.fs_hz
        vcount = souts.vcount
        means_i = np.asarray(souts.mean_i, dtype=np.float64)
        starts = np.asarray(souts.start).astype(np.int64) + block_offset_abs
        fracs = np.asarray(souts.frac, dtype=np.float64)
        carrs = np.asarray(souts.rem_carr_phase_rad, dtype=np.float64)
        dops = np.asarray(souts.carrier_doppler_hz, dtype=np.float64)
        cn0s = np.asarray(souts.cn0_dbhz, dtype=np.float64)
        S = vcount.shape[0]
        for ch, prn in enumerate(self.channel_prn):
            if prn is None:
                continue
            nv = int(souts.n_valid[ch])
            if nv == 0:
                if not bool(souts.active[ch]):
                    self._release(ch, prn, "lost lock")
                continue
            dec = self.decoders.get(prn)
            base_sym = self.sym_count[prn]
            b0 = int(sym_off[ch])
            carry = self._sym_carry.setdefault(
                prn, [0.0, 0, (N - b0) % N, None])
            if carry[2] != (N - b0) % N:
                # phase slip (mode switch / reacquisition): resync
                self._flush_sym_carry(prn)
                carry = self._sym_carry[prn]
                carry[2] = (N - b0) % N
            hist = self.histories[prn]
            acc = self.carrier_phase_acc.get(prn, 0.0)
            prev_carr = self.last_carr_rem.get(prn)
            prev_s = self._ledger_prev_start.get(prn)
            # one batched decoder push per segment
            emit_v: list[np.ndarray] = []
            emit_s: list[np.ndarray] = []
            for s in range(S):
                k = int(vcount[s, ch])
                if k == 0:
                    if s > 0:
                        break           # valid slots form a prefix
                    continue
                if s >= 1:
                    s_m = float(starts[s, ch])
                    carr_m = float(carrs[s, ch])
                    dop_m = float(dops[s, ch])
                    if prev_s is not None and prev_carr is not None:
                        est = 2.0 * np.pi * dop_m * (s_m - prev_s) / fs
                        resid = carr_m - prev_carr - est
                        acc += est + (np.mod(resid + np.pi, 2.0 * np.pi)
                                      - np.pi)
                    prev_s, prev_carr = s_m, carr_m
                    if dec is not None:
                        e_s = b0 + (s - 1) * N
                        tow = dec.tow_at_symbol(base_sym + e_s)
                        if tow is not None:
                            hist.push(s_m + float(fracs[s, ch]), tow,
                                      dop_m, acc, float(cn0s[s, ch]))
                if dec is not None:
                    if carry[1] == 0:
                        carry[3] = int(starts[s, ch])
                    carry[0] += float(means_i[s, ch])
                    carry[1] += k
                    carry[2] += k
                    if carry[2] >= N:
                        pend = carry[1]
                        st0 = int(carry[3])
                        emit_v.append(np.full(pend, carry[0]))
                        emit_s.append(
                            st0 + np.arange(pend, dtype=np.int64) * t0)
                        carry[0], carry[1], carry[2], carry[3] = \
                            0.0, 0, 0, None
            if dec is not None and emit_v:
                dec.push(np.concatenate(emit_v), np.concatenate(emit_s))
            self.carrier_phase_acc[prn] = acc
            if prev_carr is not None:
                self.last_carr_rem[prn] = prev_carr
            if prev_s is not None:
                self._ledger_prev_start[prn] = prev_s
            self.sym_count[prn] = base_sym + nv
            if self._watchdog(ch, prn, dec, nv):
                continue
            if not bool(souts.active[ch]):
                self._release(ch, prn, "lost lock")

    def _maybe_extend(self) -> None:
        """State 2 -> 3/4 switch once telemetry reports bit / secondary
        sync: coherent extension over extend_correlation_symbols epochs
        aligned to each channel's bit grid, with the narrow loop bandwidths
        (dll_pll_veml_tracking.cc:1774-1900).  On L5 (NH10), E5a (CS20) and
        B1I/B3I (NH20) the switch also enables the chain's in-loop
        secondary wipe-off at the host-synced code phase."""
        if self.trk_kind != "dll_pll":
            return          # the KF tracker has no extended/narrow states
        n = self.trk.cfg.extend_correlation_symbols
        period = self._sec_period
        if n <= 1 or period is None or period % n != 0:
            return
        # state.mode is host-written only (activate_channel /
        # enable_extended) — the host shadow avoids a device sync
        for ch, prn in enumerate(self.channel_prn):
            if prn is None or self._mode_host[ch] != 0:
                continue
            dec = self.decoders.get(prn)
            sec_phase = None
            if self.cfg.signal_id == "1C":
                bit0 = getattr(dec, "bit_offset", None)
            else:
                bit0 = getattr(dec, "sec_sync_offset", None)
                if bit0 is not None:
                    # secondary-chip index of the next epoch the card
                    # processes (harvested epochs == sym_count)
                    sec_phase = (self.sym_count[prn] - bit0) % period
            if bit0 is None:
                continue
            e = (bit0 - self.sym_count[prn]) % period
            self.state = self.trk.enable_extended(self.state, ch, e,
                                                  sec_phase=sec_phase)
            self._mode_host[ch] = 1
            log.info("ch %d PRN %d -> extended coherent (%d ms, boundary in "
                     "%d epochs)", ch, prn, n, e)

    def _monitor_tap(self, ch, prn, prompts, ep_starts, ep_dops, ep_cn0,
                     acc_series) -> None:
        """Stream decimated Gnss_Synchro records (gnss_synchro_monitor
        analogue: one record per channel per monitor_decimation epochs)."""
        spec = self.cfg.spec
        dec = self.decoders.get(prn)
        step = max(1, self.cfg.monitor_decimation)
        recs = []
        for k in range(0, len(prompts), step):
            sym = self.sym_count[prn] - len(prompts) + k
            tow = dec.tow_at_symbol(sym) if dec is not None else None
            acq = self._acq_info.get(prn, (0.0, 0.0, 0))
            recs.append(GnssSynchro(
                system=spec.system[0], signal=spec.signal_id, prn=prn,
                channel_id=ch,
                acq_delay_samples=acq[0], acq_doppler_hz=acq[1],
                acq_samplestamp_samples=acq[2], flag_valid_acquisition=True,
                prompt_i=float(prompts[k].real),
                prompt_q=float(prompts[k].imag),
                cn0_db_hz=float(ep_cn0[k]),
                carrier_doppler_hz=float(ep_dops[k]),
                carrier_phase_rads=float(acc_series[k]),
                code_phase_samples=float(ep_starts[k] % max(
                    1, self.samples_per_code)),
                tracking_sample_counter=int(ep_starts[k]),
                flag_valid_symbol_output=True,
                tow_at_current_symbol_ms=0.0 if tow is None else tow * 1e3,
                flag_valid_word=tow is not None,
            ))
        if recs:
            self.monitor.send_synchro(recs)

    # ---------------- telecommand target (TcpCmdInterface contract) ------

    def status(self) -> str:
        """One-line receiver state for the `status` telecommand."""
        n_track = sum(1 for p in self.channel_prn if p is not None)
        n_eph = sum(1 for d in self.decoders.values()
                    if d.ephemeris_complete)
        last = self.solutions[-1] if self.solutions else None
        pos = (f"lat {last.lat_deg:.5f} lon {last.lon_deg:.5f} "
               f"h {last.height_m:.1f}" if last else "no fix")
        return (f"channels {n_track}/{self.cfg.n_channels} tracking, "
                f"{n_eph} ephemerides, {len(self.solutions)} fixes, {pos}")

    def standby(self) -> None:
        self._standby = True

    def reset(self) -> None:
        self._standby = False

    def cold_start(self) -> None:
        """Drop all channels, decoders and fixes (control_thread.cc
        cold-start path)."""
        for ch in range(self.cfg.n_channels):
            if self.channel_prn[ch] is not None:
                self.state = self.trk.deactivate_channel(self.state, ch)
            self.channel_prn[ch] = None
            self._empty_acq_streak = 0
        self.decoders.clear()
        self.histories.clear()
        self.solutions.clear()
        self.obs_epochs.clear()
        self.rx_tow_s = None
        self._next_obs_sample = None

    def warm_start(self, lat, lon, h, utc: str) -> None:
        """Store an a-priori position for assisted acquisition."""
        self.apriori_ecef = llh_to_ecef(np.radians(lat), np.radians(lon), h)

    hot_start = warm_start

    # ---------------- observables + PVT ----------------

    def _eph_for(self, prn: int):
        dec = self.decoders.get(prn)
        if dec is not None and dec.ephemeris_complete:
            return dec.ephemeris
        return None

    def _observables_and_pvt(self) -> None:
        cfg = self.cfg
        tick = int(round(cfg.fs_hz * cfg.obs_interval_ms * 1e-3))
        ready_hist = {
            p: h for p, h in self.histories.items()
            if p in self.decoders and self._eph_for(p) is not None
            and len(h.start_samples) >= 2
        }
        if len(ready_hist) < 4:
            return
        if self._next_obs_sample is None:
            earliest = max(h.start_samples[0] for h in ready_hist.values())
            self._next_obs_sample = ((earliest // tick) + 1) * tick
        # process all ticks fully covered by every ready history
        covered = min(h.start_samples[-1] for h in ready_hist.values())
        while self._next_obs_sample <= covered:
            rx_sample = self._next_obs_sample
            if self.rx_tow_s is None:
                rx_tow, obs = compute_observables(ready_hist, rx_sample,
                                                  cfg.fs_hz, None)
                if obs:
                    self.rx_tow_s = rx_tow
                    self.rx_tow_sample = rx_sample
            else:
                rx_tow = self.rx_tow_s + (rx_sample - self.rx_tow_sample) \
                    / cfg.fs_hz
                _, obs = compute_observables(ready_hist, rx_sample,
                                             cfg.fs_hz, rx_tow)
            if obs:
                self.obs_epochs.append((rx_tow, obs))
            # PVT.output_rate_ms: solve at the configured cadence while
            # observables (and the Hatch smoother state) keep the full
            # obs_interval rate
            pvt_decim = max(1, (cfg.pvt_output_rate_ms or 0)
                            // cfg.obs_interval_ms)
            solve_now = (rx_sample // tick) % pvt_decim == 0
            if len(obs) >= 4:
                prs = {p: o.pseudorange_m for p, o in obs.items()}
                if self._smoother is not None:
                    prs = {p: self._smoother.smooth(
                        p, o.pseudorange_m, o.carrier_phase_cycles)
                        for p, o in obs.items()}
            if len(obs) >= 4 and solve_now:
                ephs = {p: self._eph_for(p) for p in obs}
                iono = None
                if cfg.iono_model == "broadcast":
                    for p in obs:
                        dec_iono = getattr(self.decoders[p], "iono", None)
                        if dec_iono is not None and dec_iono.valid:
                            iono = dec_iono
                            break
                sol = solve_pvt(
                    ephs, prs, rx_tow,
                    dopplers_hz={p: o.doppler_hz for p, o in obs.items()},
                    carrier_freq_hz=cfg.spec.carrier_freq_hz,
                    iono=iono,
                    apply_tropo=cfg.trop_model == "saastamoinen",
                    el_mask_deg=cfg.elevation_mask_deg,
                    weighted=cfg.pvt_weighted,
                    raim=cfg.raim,
                    raim_sigma_m=cfg.raim_sigma_m,
                )
                if sol.valid:
                    self.solutions.append(sol)
                    if self.pvt_monitor is not None:
                        self.pvt_monitor.send_pvt(sol)
            self._next_obs_sample += tick

    def _scale_for(self, samples) -> float:
        """Unit-RMS ingest normalization (computed once): bounds prompt
        magnitudes; every acquisition/CN0/lock statistic is
        scale-invariant."""
        if self._ingest_scale is None:
            head = np.asarray(samples[: min(len(samples), 1 << 18)])
            rms = float(np.sqrt(np.mean(np.abs(head) ** 2)))
            self._ingest_scale = 1.0 / rms if rms > 0 else 1.0
        return self._ingest_scale

    # ---------------- main loop ----------------

    def _segment_scale(self, samples) -> np.float32:
        """Scale of the tracking input: unit RMS for the DLL/PLL engine;
        the KF tracker takes the samples as they are, as the reference's
        KF path does."""
        if self.trk_kind == "kf":
            return np.float32(1.0)
        return np.float32(self._scale_for(samples))

    def preload(self, samples: np.ndarray) -> None:
        """Upload the whole capture to device memory once (complex64, at
        the tracking input's scale); process(samples) then slices tracking
        segments on the device instead of uploading per segment."""
        self._samples_dev = to_device(samples, self.device) \
            * self._segment_scale(samples)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _kf_track_segment(self, seg, span: int):
        """Segment tracking through the KF engine: the segment's blocks in
        one call (one kf_block launch on the card).  Returns (state,
        TrackOutputs with segment-relative epoch starts)."""
        base = int(round(self.cfg.fs_hz * self.cfg.block_ms * 1e-3))
        st, cat = self.trk.track_blocks(seg, self.state, base, span // base)
        return st, TrackOutputs(
            valid=cat.valid, start=cat.start, cur_len=cat.cur_len,
            correlators=cat.correlators,
            carrier_doppler_hz=cat.carrier_doppler_hz,
            code_freq_delta=cat.code_freq_delta,
            rem_code_phase_samples=cat.rem_code_phase_samples,
            rem_carr_phase_rad=cat.rem_carr_phase_rad,
            cn0_dbhz=cat.cn0_dbhz, active=cat.active)

    def process(self, samples: np.ndarray) -> list[PvtSolution]:
        """Run the receiver over a full capture (complex64 at fs).

        Tracking runs in multi-block device segments (one host round-trip
        per segment); the channel FSM, telemetry, observables and PVT run on
        the host between segments."""
        cfg = self.cfg
        base = int(round(cfg.fs_hz * cfg.block_ms * 1e-3))
        nmax = self.trk.cfg.epoch_samples_max
        total = len(samples)
        seg_blocks = max(1, cfg.reacq_interval_blocks)
        abs_base = self._abs_base
        self._pos = 0
        while self._pos + base + nmax <= total:
            if self._standby:
                break
            need = self.acq.cfg.fft_size * max(1, cfg.acq_dwells)
            if self._pos + need <= total:
                # acquisition and activation run in call-relative sample
                # coordinates (the tracking segment frame)
                self._acquire_and_assign(
                    self._pos, samples[self._pos:self._pos + need])
            # keep segments short through pull-in (an idle channel with
            # satellites still acquirable, or an active channel without bit
            # sync) so satellites (re)acquire at the reference's channel-FSM
            # latency; steady state gets the full segment
            seg_now = seg_blocks
            idle_wants_acq = any(p is None for p in self.channel_prn) \
                and self._empty_acq_streak < 5
            if idle_wants_acq or not self._pull_in_done():
                seg_now = min(seg_blocks, 25)
            n_blocks = min(seg_now, (total - self._pos - nmax) // base)
            if n_blocks < 1:
                break
            span = n_blocks * base
            sdev = self._samples_dev
            if sdev is not None and sdev.shape[0] >= self._pos + span + nmax:
                seg_dev = sdev[self._pos:self._pos + span + nmax]
            else:
                seg_dev = to_device(
                    samples[self._pos:self._pos + span + nmax], self.device) \
                    * self._segment_scale(samples)
            sym_off = self._symbol_offsets()
            if self.trk_kind == "kf":
                self.state, outs = self._kf_track_segment(seg_dev, span)
                self._harvest(outs, abs_base + self._pos)
            elif sym_off is not None:
                self.state, souts = self.trk.track_capture_symbols(
                    seg_dev, self.state, span, sym_off, self._sec_period)
                self._harvest_symbols(souts, abs_base + self._pos, sym_off)
            else:
                self.state, outs = self.trk.track_capture(
                    seg_dev, self.state, span)
                self._harvest(outs, abs_base + self._pos,
                              decim=self.trk.capture_decim)
            self._maybe_extend()
            self._observables_and_pvt()
            self._pos += span
            self._blocks_done += n_blocks
        self._abs_base = abs_base + self._pos
        return self.solutions

    def process_stream(self, blocks, segment_s: float = 1.0,
                       raw_format: str | None = None) -> list[PvtSolution]:
        """Streaming pipeline: double-buffered device segments.

        `blocks` yields (offset, chunk) like FileSignalSource.blocks() or
        the io.network sources: complex64 chunks, or raw interleaved
        integer items when `raw_format` names an io.formats entry (ishort,
        ibyte, cshort, cbyte) or nibble-packed 2bits_cpx.  Raw items cross
        to the card as they are (ishort 4 B a sample, ibyte 2 B, 2bits_cpx
        0.5 B, against complex64's 8 B), staged in two reusable pinned
        host buffers, and unpack
        there (runtime.stream.unpack_raw); only the acquisition head of a
        segment is converted on the host.

        Segment k+1 is launched, and its readback queued, before segment k
        is harvested, so the host's harvest of k overlaps the card's work
        on k+1.  The channel FSM therefore runs one segment behind the
        card: an assignment applies at launch, extension and lock release
        at harvest (the JAX package's order, its receiver.py:1405-1444).
        Unlike the JAX package's stream, the harvest of k reads each
        channel only if it still holds the assignment it had when k was
        launched: a channel released and assigned anew in between (the
        acquisition for k+1 runs before the harvest of k) carries its
        previous occupant's rows in k, which the JAX package hands to the
        new decoder (or takes for a lost lock and releases the new
        assignment).  The final partial segment is dropped (a live stream
        has no end of capture to flush).  The DLL/PLL engine only."""
        if self.trk_kind != "dll_pll":
            raise ValueError("process_stream supports the DLL/PLL engine")
        cfg = self.cfg
        base = int(round(cfg.fs_hz * cfg.block_ms * 1e-3))
        span = max(1, int(round(segment_s / (cfg.block_ms * 1e-3)))) * base
        nmax = self.trk.cfg.epoch_samples_max
        abs_base = self._abs_base
        fmt = FORMATS[raw_format] if raw_format is not None else None
        if fmt is not None and fmt.name not in STREAM_FORMATS:
            raise ValueError(
                "raw streaming supports interleaved I/Q integer formats "
                "(ishort/ibyte/cshort/cbyte) and 2bits_cpx")
        ipc = fmt.items_per_sample if fmt is not None else 1
        spi = fmt.samples_per_item if fmt is not None else 1

        def n_items(n_samples: int) -> int:
            return (n_samples * ipc + spi - 1) // spi

        if (span * ipc) % spi:
            raise ValueError("segment span must align to whole raw items")
        need_samps = span + nmax
        staging = PinnedStaging(self.device)
        buf_parts: list[np.ndarray] = []
        buf_len = 0                     # samples buffered
        consumed = 0                    # samples launched (stream-relative)
        pending: list[tuple] = []
        reacq_countdown = 0
        for _, chunk in blocks:
            chunk = np.asarray(chunk)
            buf_parts.append(chunk)
            buf_len += len(chunk) * spi // ipc
            while buf_len >= need_samps and not self._standby:
                buf = np.concatenate(buf_parts) if len(buf_parts) > 1 \
                    else buf_parts[0]
                # acquisition on the segment head (idle channels only)
                if reacq_countdown <= 0:
                    need = self.acq.cfg.fft_size * max(1, cfg.acq_dwells)
                    if buf_len >= need:
                        head = buf[: n_items(need)]
                        xc = convert_to_complex64(head, fmt)[:need] \
                            if fmt is not None else head
                        self._pos = consumed
                        self._acquire_and_assign(consumed, xc)
                    reacq_countdown = max(1, cfg.reacq_interval_blocks
                                          // max(1, span // base))
                reacq_countdown -= 1
                seg = buf[: n_items(need_samps)]
                if fmt is not None:
                    if self._ingest_scale is None:
                        self._scale_for(convert_to_complex64(
                            buf[: n_items(min(buf_len, 1 << 18))], fmt))
                    seg_dev = unpack_raw(staging.upload(seg), fmt.name,
                                         self._ingest_scale)[:need_samps]
                else:
                    scale = np.float32(self._scale_for(seg))
                    seg_dev = staging.upload(
                        np.asarray(seg, np.complex64)) * scale
                owners = [(p, self.decoders.get(p))
                          for p in self.channel_prn]
                self.state, readback = self.trk.launch_capture(
                    seg_dev, self.state, span)
                pending.append((readback, consumed, owners))
                buf_parts = [buf[span * ipc // spi:]]
                buf_len -= span
                consumed += span
                self._blocks_done += span // base
                # harvest the previous segment while this one computes
                if len(pending) > 1:
                    self._harvest_segment(*pending.pop(0), abs_base)
        while pending:
            self._harvest_segment(*pending.pop(0), abs_base)
        self._abs_base = abs_base + consumed
        self._pos = 0
        return self.solutions

    def _harvest_segment(self, readback, seg_start: int, owners,
                         abs_base: int) -> None:
        """process_stream's harvest of one launched segment: wait for its
        readback only, then the host stages."""
        outs = self.trk.harvest_capture(readback)
        self._harvest(outs, abs_base + seg_start,
                      decim=self.trk.capture_decim, owners=owners)
        self._maybe_extend()
        self._observables_and_pvt()

    # ---------------- checkpoint / resume ----------------

    # the JAX package's _CKPT_FIELDS, and _empty_acq_streak (its segment
    # gating state; the JAX package does not carry it across a resume)
    _CKPT_FIELDS = (
        "channel_prn", "decoders", "histories", "sym_count", "last_rem",
        "last_frac", "carrier_phase_acc", "last_carr_rem", "rx_tow_s",
        "rx_tow_sample", "solutions", "obs_epochs", "_blocks_done",
        "_next_obs_sample", "_standby", "_abs_base", "_no_tow_syms",
        "_acq_info", "_ledger_prev_start", "_ingest_scale", "_smoother",
        "_sym_carry", "_mode_host", "_empty_acq_streak",
    )

    def checkpoint(self, path: str) -> None:
        """Snapshot the complete receiver state — the tracking state,
        per-channel decoder FSMs, observables histories, RX clock,
        solutions — so a later resume_from() continues the run exactly.
        The tracking state is saved as numpy arrays (state_to_numpy): the
        file holds host objects only, so a checkpoint taken on the card
        resumes on the CPU and the other way round.  The JAX package's
        checkpoints pickle its own classes; this package does not load
        them."""
        import pickle

        blob = {"version": 1, "cfg": self.cfg,
                "track_state": state_to_numpy(self.state)}
        for name in self._CKPT_FIELDS:
            blob[name] = getattr(self, name, None)
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    @classmethod
    def resume_from(cls, path: str, device=None) -> "Receiver":
        """Rebuild a Receiver from a checkpoint() on `device` (None: the
        card); feed the remaining samples to process() and the run
        continues where it left off."""
        import pickle

        with open(path, "rb") as f:
            blob = pickle.load(f)
        if blob.get("version") != 1:
            raise ValueError(f"unsupported checkpoint version: "
                             f"{blob.get('version')}")
        rx = cls(blob["cfg"], device=device)
        rx.state = state_from_numpy(blob["track_state"], rx.device)
        for name in cls._CKPT_FIELDS:
            if blob.get(name) is not None:
                setattr(rx, name, blob[name])
        if blob.get("_mode_host") is None:
            rx._mode_host = np.asarray(blob["track_state"]["mode"],
                                       dtype=np.int32).copy()
        return rx


# the telemetry decoder of each signal's channels (the signals this package
# carries)
_DECODERS = {"1C": LnavDecoder, "2S": GpsL2ChannelDecoder,
             "L5": GpsL5ChannelDecoder, "1B": GalileoChannelDecoder,
             "5X": GalileoE5aChannelDecoder, "1G": GlonassChannelDecoder,
             "2G": GlonassChannelDecoder, "B1": BeidouChannelDecoder,
             "B3": BeidouChannelDecoder}
