"""The receiver's device work over a mesh: channel-sharded tracking and
acquisition, and the time-sharded conditioner.

`ChannelShardedEngine` is one `TrackingEngine` per mesh entry, each with
the same `TrackConfig` but `n_channels` (its share) and the full slot
table, on the entry's device.  A capture call enqueues every shard before
it harvests any, each CUDA shard on its own stream under its own device
(the kernels' C entries act on the current device and stream), and
returns what the unsharded engine returns, channels in global order.  No
copy between devices and no collective runs between the first launch and
the last harvest: channels are independent until observables fan in on
the host (JAX `track/engine.py:862-865`).

The one place the JAX package's sharded program reduces over channels is
the gather walk's window origin `m`, the least start over the active
channels of an epoch (JAX `engine.py:801`), which XLA's partitioner takes
over every shard; a shard's walk takes it over its own channels.  Each
channel's window is the same either way unless the clamp `win - n_max`
bites, which it does only for channels whose starts lie more than a code
period apart.  The sharded gather engine checks every epoch of every
launch from the rows it reads back, and raises where the split moved a
channel's window: a result it returns is the unsharded engine's, bit for
bit.

`ChannelShardedAcquisition` splits the PRN rows of the PCPS grid over the
mesh (JAX `__graft_entry__.py` `dryrun_multichip` shards `_pcps_core` so);
`freq_xlating_fir_time_sharded` runs the conditioner over time blocks, the
blocks joined by `halo_exchange_blocks`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..acquire.pcps import AcqConfig, AcqResult, PcpsAcquisition
from ..condition.filters import Conditioner, to_device
from ..ops.track_chain import O_ACTIVE, O_VALID
from ..track.config import TrackConfig
from ..track.engine import SymbolOutputs, TrackingEngine, TrackOutputs
from .sharding import (ChannelShards, Mesh, _tree_map, channel_mesh,
                       halo_exchange_blocks, replicate, time_mesh)


@contextlib.contextmanager
def _on(device: torch.device, stream):
    """Run on `device` and its shard's `stream` (nothing on the CPU)."""
    if stream is None:
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


class _Shards:
    """The devices of a mesh's local entries, each with a stream of its own
    on CUDA: two entries naming one device run on two streams.  `launch`
    orders every shard stream after its device's current stream, runs the
    shards in turn, then orders each device's current stream after its
    shards' streams (a later use of their outputs, and a later reuse of
    their memory, waits for them)."""

    def __init__(self, mesh: Mesh):
        self.devices = mesh.local_devices()
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in self.devices]

    def launch(self, fn, *per_shard):
        pairs = [(d, s) for d, s in zip(self.devices, self.streams)
                 if s is not None]
        for d, s in pairs:
            s.wait_stream(torch.cuda.current_stream(d))
        out = []
        for j, (d, s) in enumerate(zip(self.devices, self.streams)):
            with _on(d, s):
                out.append(fn(j, *(a[j] for a in per_shard)))
        for d, s in pairs:
            torch.cuda.current_stream(d).wait_stream(s)
        return out

    def each(self, fn, *per_shard):
        """fn(j, ...) for every shard under its device and stream, without
        ordering (the harvest: each readback waits for its own event)."""
        out = []
        for j, (d, s) in enumerate(zip(self.devices, self.streams)):
            with _on(d, s):
                out.append(fn(j, *(a[j] for a in per_shard)))
        return out


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host: queued into pinned memory on the current stream
    for a CUDA tensor (complete once that stream's later work is), a copy
    on the CPU."""
    if t.device.type != "cuda":
        return t.clone()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


def _read_rows(t: torch.Tensor):
    """(host copy of `t`, the event after it on the current stream, None
    on the CPU) for `_wait`."""
    h = _host_copy(t)
    if t.device.type != "cuda":
        return h, None
    event = torch.cuda.Event()
    event.record()
    return h, event


def _wait(rows) -> np.ndarray:
    h, event = rows
    if event is not None:
        event.synchronize()
    return h.numpy()


class _WalkRows(NamedTuple):
    """A gather segment's per-epoch rows the window check reads: valid,
    start and active after each epoch (host copies)."""

    valid: torch.Tensor
    start: torch.Tensor
    active: torch.Tensor


class ShardedReadback(NamedTuple):
    """Every shard's CaptureReadback of a launched segment, and for the
    gather walk's check each shard's active flags entering it and the
    capture's length."""

    readbacks: list
    active_in: list
    n_samp: int


def _concat(parts: list, cls):
    """NamedTuples of per-shard numpy fields joined along the channel axis
    (the last: [n, C, ...] rows of TrackOutputs are taken along axis 1)."""
    axis = 1 if cls is TrackOutputs else -1
    return cls(*(np.concatenate(f, axis=axis) for f in zip(*parts)))


class ChannelShardedEngine:
    """The DLL/PLL tracking engine with its channels sharded over a mesh
    (chunked or gather correlator, as `cfg.correlator` says).

    Global channel ch lives in shard ch // P at ch % P (P = n_channels /
    mesh size), the layout of `shard_channel_tree`.  States are
    `ChannelShards` of per-shard `TrackState`s; samples are one tensor per
    mesh entry (`replicate`), or a tensor or array that the engine
    replicates itself."""

    def __init__(self, cfg: TrackConfig, codes: np.ndarray,
                 sec_codes: np.ndarray | None = None,
                 mesh: Mesh | None = None):
        self.mesh = channel_mesh() if mesh is None else mesh
        self._shards = _Shards(self.mesh)
        n = len(self._shards.devices)
        if cfg.n_channels % n:
            raise ValueError(f"{cfg.n_channels} channels do not split over "
                             f"{n} mesh entries")
        self.cfg = cfg
        self.per_shard = cfg.n_channels // n
        shard_cfg = dataclasses.replace(cfg, n_channels=self.per_shard)
        self.engines = [TrackingEngine(shard_cfg, codes, sec_codes, device=d)
                        for d in self._shards.devices]
        self.correlator = self.engines[0].correlator

    # ---------------- state (host) ----------------

    def init_state(self) -> ChannelShards:
        shards = [e.init_state() for e in self.engines]
        return ChannelShards(shards, self.mesh,
                             _tree_map(lambda _: True, shards[0]))

    def _one(self, state: ChannelShards, ch: int, fn) -> ChannelShards:
        if not 0 <= ch < self.cfg.n_channels:
            raise IndexError(f"channel {ch} outside [0, "
                             f"{self.cfg.n_channels})")
        j, local = divmod(ch, self.per_shard)
        shards = list(state)
        shards[j] = fn(self.engines[j], shards[j], local)
        return state.replace(shards)

    def activate_channel(self, state: ChannelShards, ch: int, *args,
                         **kw) -> ChannelShards:
        """TrackingEngine.activate_channel on global channel `ch`."""
        return self._one(state, ch, lambda e, s, c: e.activate_channel(
            s, c, *args, **kw))

    def enable_extended(self, state: ChannelShards, ch: int, *args,
                        **kw) -> ChannelShards:
        return self._one(state, ch, lambda e, s, c: e.enable_extended(
            s, c, *args, **kw))

    def deactivate_channel(self, state: ChannelShards,
                           ch: int) -> ChannelShards:
        return self._one(state, ch,
                         lambda e, s, c: e.deactivate_channel(s, c))

    def rebase(self, state: ChannelShards, base: int) -> ChannelShards:
        return state.replace([e.rebase(s, base)
                              for e, s in zip(self.engines, state)])

    # ---------------- capture calls ----------------

    def _inputs(self, samples, state: ChannelShards):
        if not isinstance(state, ChannelShards) or \
                len(state) != len(self.engines):
            raise ValueError(f"the state must be the engine's "
                             f"ChannelShards of {len(self.engines)} shards")
        if isinstance(samples, (list, tuple)):
            xs = list(samples)
        else:
            x = samples if torch.is_tensor(samples) else torch.from_numpy(
                np.ascontiguousarray(samples, dtype=np.complex64))
            xs = replicate(x.to(torch.complex64), self.mesh)
        if len(xs) != len(self.engines):
            raise ValueError(f"{len(xs)} sample tensors for "
                             f"{len(self.engines)} shards")
        for x, d in zip(xs, self._shards.devices):
            if x.device != d:
                raise ValueError(f"a shard on {d} was given samples on "
                                 f"{x.device}")
        return xs

    def launch_capture(self, samples, state: ChannelShards, span: int):
        """Enqueue every shard's capture segment, then queue every shard's
        readback, without waiting: (state rebased by span, ShardedReadback
        for harvest_capture)."""
        xs = self._inputs(samples, state)

        def one(j, x, st):
            active_in = _host_copy(st.active)
            st2, rb = self.engines[j].launch_capture(x, st, span)
            return st2, rb, active_in

        res = self._shards.launch(one, xs, list(state))
        return (state.replace([r[0] for r in res]),
                ShardedReadback([r[1] for r in res], [r[2] for r in res],
                                int(xs[0].shape[0])))

    def harvest_capture(self, rb: ShardedReadback,
                        decim: int | None = None) -> TrackOutputs:
        """Wait for each shard's readback and join their TrackOutputs in
        global channel order (on the gather path after the window check)."""
        outs = self._shards.each(
            lambda j, r: self.engines[j].harvest_capture(r, decim),
            rb.readbacks)
        out = _concat(outs, TrackOutputs)
        if self.correlator == "gather":
            self._check_windows(rb.n_samp, rb.active_in, out.valid,
                                out.start, out.active)
        return out

    def track_capture(self, samples, state: ChannelShards, span: int):
        """TrackingEngine.track_capture over the shards: (state rebased by
        span, TrackOutputs of every channel)."""
        st, rb = self.launch_capture(samples, state, span)
        return st, self.harvest_capture(rb)

    def track_block(self, samples, state: ChannelShards, base: int):
        """TrackingEngine.track_block over the shards (rows at full
        rate)."""
        xs = self._inputs(samples, state)

        def one(j, x, st):
            e = self.engines[j]
            need = base + e.cfg.epoch_samples_max
            if x.shape[0] < need:
                raise ValueError(f"block must be >= base+epoch_samples_max "
                                 f"= {need}, got {x.shape[0]}")
            active_in = _host_copy(st.active)
            st2, out_f, out_i, out_corr = e._run_capture(
                x, st, base, base // (e._t0_int - 2) + 2)
            return (e.rebase(st2, base), e._read_back(out_f, out_i, out_corr),
                    active_in)

        res = self._shards.launch(one, xs, list(state))
        out = self.harvest_capture(
            ShardedReadback([r[1] for r in res], [r[2] for r in res],
                            int(xs[0].shape[0])), decim=1)
        return state.replace([r[0] for r in res]), out

    def track_capture_symbols(self, samples, state: ChannelShards,
                              span: int, sym_off, sym_n: int):
        """TrackingEngine.track_capture_symbols over the shards: `sym_off`
        [C] in global channel order; (state rebased by span, SymbolOutputs
        of every channel)."""
        xs = self._inputs(samples, state)
        offs = np.asarray(sym_off).reshape(len(self.engines), self.per_shard)
        gather = self.correlator == "gather"

        def one(j, x, st):
            e = self.engines[j]
            n_epochs = e._check_capture(x, span)
            entering_rem = st.rem_code_phase_samples
            active_in = _host_copy(st.active) if gather else None
            st2, out_f, out_i, out_corr = e._run_capture(x, st, span,
                                                         n_epochs)
            rows = None
            if gather:
                rows = _WalkRows(_host_copy(out_f[:, O_VALID]),
                                 _host_copy(out_i[:, 0]),
                                 _host_copy(out_f[:, O_ACTIVE]))
            return (e.rebase(st2, span), (out_f, out_i, out_corr,
                                          entering_rem), rows, active_in)

        res = self._shards.launch(one, xs, list(state))
        # each reduction's readback waits for the event after it on its
        # shard's stream, the rows' host copies queued there before included
        syms = self._shards.each(
            lambda j, r, off: self.engines[j]._symbol_outputs(
                *r[1], off, int(sym_n)), res, list(offs))
        if gather:
            rows = [r[2] for r in res]
            self._check_windows(
                int(xs[0].shape[0]), [r[3] for r in res],
                np.concatenate([w.valid.numpy() > 0.5 for w in rows], 1),
                np.concatenate([w.start.numpy() for w in rows], 1),
                np.concatenate([w.active.numpy() > 0.5 for w in rows], 1))
        return (state.replace([r[0] for r in res]),
                _concat(syms, SymbolOutputs))

    # ---------------- the gather walk's window origin ----------------

    def _check_windows(self, n_samp: int, active_in: list, valid, start,
                       active) -> None:
        """Raise where a shard's window origin gave a valid channel another
        window than the unsharded walk's origin over every channel would
        have (ops/gather_block.py `window_offsets`).  Rows [n, C] in global
        order: valid, start and active after each epoch; `active_in` each
        shard's active flags entering the first."""
        e = self.engines[0]
        win = min(e._win, n_samp)
        slack = win - e.cfg.epoch_samples_max
        act0 = np.concatenate([np.asarray(a.numpy(), bool)
                               for a in active_in])
        act = np.concatenate([act0[None], active[:-1]], axis=0)

        def origins(cols):
            lo = np.where(act[:, cols], start[:, cols], 1 << 29).min(axis=1)
            m = np.clip(lo, 0, n_samp - win)[:, None]
            return m, m + np.clip(start[:, cols] - m, 0, slack)

        m_all, every = origins(slice(None))
        P = self.per_shard
        for j in range(len(self.engines)):
            cols = slice(j * P, (j + 1) * P)
            moved = valid[:, cols] & (origins(cols)[1] != every[:, cols])
            if moved.any():
                k, c = map(int, np.argwhere(moved)[0])
                ch = j * P + c
                raise RuntimeError(
                    f"the channel split moves the gather walk's window: "
                    f"channel {ch} starts epoch {k} "
                    f"{int(start[k, ch] - m_all[k, 0])} samples past the "
                    f"whole walk's window origin, beyond its {slack}-sample "
                    f"slack, and shard {j} holds no channel at that origin; "
                    f"channels whose starts lie more than a code period "
                    f"apart must share a shard")


class ChannelShardedAcquisition:
    """PCPS acquisition with the PRN rows of the grid split over a mesh:
    one `PcpsAcquisition` per mesh entry over a contiguous block of the
    sorted PRNs, each on its entry's device and stream; `acquire` searches
    every shard before it reads any back, and returns the unsharded
    AcqResult (PRNs in sorted order)."""

    def __init__(self, cfg: AcqConfig, codes_by_prn: dict[int, np.ndarray],
                 mesh: Mesh | None = None,
                 fs_code_rate: tuple[float, int] | None = None,
                 freq_offsets_by_prn: dict[int, float] | None = None):
        self.mesh = channel_mesh() if mesh is None else mesh
        self._shards = _Shards(self.mesh)
        self.cfg = cfg
        self.prns = sorted(codes_by_prn)
        blocks = np.array_split(np.asarray(self.prns),
                                len(self._shards.devices))
        if any(len(b) == 0 for b in blocks):
            raise ValueError(f"{len(self.prns)} PRNs for "
                             f"{len(blocks)} mesh entries")
        offs = freq_offsets_by_prn or {}
        self.acqs = [PcpsAcquisition(
            cfg, {int(p): codes_by_prn[int(p)] for p in b}, fs_code_rate,
            {int(p): offs[int(p)] for p in b if int(p) in offs} or None,
            device=d) for b, d in zip(blocks, self._shards.devices)]

    def acquire(self, samples: np.ndarray, samplestamp: int = 0) -> AcqResult:
        rows = self._shards.launch(
            lambda j: _read_rows(self.acqs[j].search(samples)))
        return self.acqs[0].result(
            np.concatenate([_wait(r) for r in rows], axis=1), samplestamp)

    @property
    def threshold(self) -> float:
        return self.acqs[0].threshold


def freq_xlating_fir_time_sharded(x, taps: np.ndarray, fs_hz: float,
                                  if_freq_hz: float = 0.0, decim: int = 1,
                                  mesh: Mesh | None = None,
                                  block_size: int = 1 << 17) -> np.ndarray:
    """`freq_xlating_fir` over time blocks on a mesh, equal to the
    one-device conditioner's output.  Entry j conditions the j-th run of
    whole `block_size` blocks with a `Conditioner` of its own, started
    where the one-device conditioner stands at that block
    (`Conditioner.start_at`).  In the stream with the conditioner's zero
    history in front, entry j's n_taps - 1 samples of history are its own
    block's head, and the history of entry j + 1 closes the block:
    `halo_exchange_blocks` appends it from the right neighbour."""
    mesh = time_mesh() if mesh is None else mesh
    devs = mesh.local_devices()
    taps = np.asarray(taps, dtype=np.float32)
    h = len(taps) - 1
    xs = to_device(x, "cpu")
    n_blocks = -(-xs.shape[0] // block_size)
    per = -(-n_blocks // len(devs))                # blocks a mesh entry
    seg = per * block_size
    used = -(-n_blocks // per)
    z = torch.cat([torch.zeros(h, dtype=torch.complex64), xs])
    parts = [z[j * seg:(j + 1) * seg].to(devs[j]) for j in range(used)]
    ext = halo_exchange_blocks(parts, h) if used > 1 else parts
    shards = _Shards(Mesh(devs[:used], mesh.axis_names[:1]))

    def one(j, e):
        cond = Conditioner(taps, fs_hz, if_freq_hz, decim, block_size,
                           device=devs[j])
        cond.start_at(e[:h], j * per)
        last = j == used - 1
        # the last entry's wrapped halo is dropped: the stream ends there
        return cond.process_tensor(e[h:parts[j].shape[0]] if last
                                   else e[h:], flush=last)

    ys = shards.launch(one, ext)
    return torch.cat([y.cpu() for y in ys]).numpy()
