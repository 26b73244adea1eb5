"""How `correct` is decided: the program's outputs against the plain
reference (`gnssbench.reference`), at the timed sizes, once the window has
closed.

The numbers compared, each against its cell's limit
(`benchmark/limits/<cell>.json`):

    start_rows_differ  entries of the state rows at the start of a pass
                       (each channel pulled in at the truth) that differ
                       from the reference's own activation
    flags_differ       valid, active and count flags that differ (per
                       epoch, per symbol slot and in the state left), and
                       channels whose next epoch, in the state left,
                       starts half an epoch or more from the reference's
    symbols_differ     data symbols whose sign differs: the prompt's real
                       part per valid epoch, or the slot mean per complete
                       symbol of the symbol grid
    corr_gap           the widest gap of a correlator tap (or slot mean)
                       of a row, over the channel's median prompt magnitude
    code_gap           code phase, samples (a row's epoch start plus its
                       remainder)
    doppler_gap        carrier Doppler, Hz
    phase_gap          carrier phase, rad, the nearer way round
    cn0_gap            C/N0, dB-Hz
    exit_*_gap         the same four of the state each segment left

Each gap is taken per channel: the median of the channel's gaps over
every compared row (epochs or symbol slots, over all compared segments;
for `exit_*` one a segment), then the largest over the channels, so a
fault in one channel shows however many channels are sound.  A median,
not the widest gap: a code index at a chip boundary can round to either
chip in float32, the two sides then correlate one sample differently and
the closed loops carry the difference for some tens of epochs, so a
widest gap reads the same order whether the program is sound or computes
in a lower precision.  The widest gaps are reported beside the numbers
(`Numbers.widest`) and not compared.  Where that rounding comes often
enough to part the loops in most epochs (the E1B walk), the cell's limits
set `head_epochs` and the per-epoch gaps are those of the first epochs of
each segment walked from the program's state (`gap_rows`).  A cell
compares the numbers its limits name; the others are reported beside
them ("not_compared").

The reference walks the first two segments of the first pass from its
own activation at the truth, so the state handed from one segment to
the next is its own there; every other compared segment it walks from
the state the program entered that segment with (a closed tracking loop
drifts apart over a pass, so it cannot be followed otherwise).  It runs
on the host, on the inputs the benchmark made: the scaled capture, or
the raw items it unpacks itself.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from .reference import chain as tc
from .reference.engine import ReferenceEngine, TrackConfig

_TWO_PI = 2.0 * np.pi


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero as the tensor cores' conversion rounds), kept as float32."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bfloat16 value, kept as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


# the control of each correlator: the reference one precision below the
# configuration's float32: TF32 lag products for the chunked correlator
# (float32 matrix products with TF32 off), bfloat16 for the gather walk's
# element-wise float32 products
CONTROL = {"chunked": round_tf32, "gather": round_bf16}


def reference_for(ctx) -> ReferenceEngine:
    tr = dict(ctx.cell.config["track"])
    tr["correlator"] = ("gather" if tr["correlator"] == "gather"
                        else "chunked")
    names = {f.name for f in dataclasses.fields(TrackConfig)}
    cfg = TrackConfig(**{k: v for k, v in tr.items() if k in names})
    return ReferenceEngine(cfg, ctx.codes, device="cpu")


def state_fields(state) -> dict:
    """A program TrackState as numpy arrays by field name."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def unpack_ishort(items: np.ndarray, scale: float) -> torch.Tensor:
    """Interleaved int16 I/Q -> complex64 times `scale` (in float32)."""
    iq = items.astype(np.float32).reshape(-1, 2) * np.float32(scale)
    return torch.from_numpy(np.ascontiguousarray(iq)).view(
        torch.complex64).reshape(-1)


# the gaps compared, each per channel: the channel's median over its
# compared rows, then the largest over the channels (`Numbers.values`)
ROW_GAPS = ("corr_gap", "code_gap", "doppler_gap", "phase_gap", "cn0_gap")
EXIT_GAPS = ("exit_code_gap", "exit_doppler_gap", "exit_phase_gap",
             "exit_cn0_gap")


class Numbers:
    """The compared numbers, summed or gathered by channel over the
    compared segments, and the widest gaps beside them."""

    def __init__(self):
        self.flags = self.start = self.symbols = 0
        # gap name -> channel -> that channel's gaps, an array a segment
        self.gaps = {n: collections.defaultdict(list)
                     for n in ROW_GAPS + EXIT_GAPS}

    def add(self, name: str, gap, mask: np.ndarray) -> None:
        """One segment's gaps [rows, C], where `mask` [rows, C] holds."""
        gap = np.asarray(gap, np.float64).reshape(mask.shape)
        for c in np.flatnonzero(mask.any(axis=0)):
            self.gaps[name][int(c)].append(gap[mask[:, c], c])

    def _by_channel(self, reduce) -> dict:
        return {n: max((float(reduce(np.concatenate(v)))
                        for v in chans.values()), default=0.0)
                for n, chans in self.gaps.items()}

    def values(self) -> dict:
        return {"start_rows_differ": float(self.start),
                "flags_differ": float(self.flags),
                "symbols_differ": float(self.symbols),
                **self._by_channel(np.median)}

    def widest(self) -> dict:
        return self._by_channel(np.max)

    def loop(self, prefix: str, got: dict, want: dict, mask) -> None:
        """The loop values of rows or states, each side a dict of arrays
        [rows, C]: `tau` (code phase), `doppler`, `phase`, `cn0`."""
        def d(k):
            return np.abs(np.asarray(got[k], np.float64)
                          - np.asarray(want[k], np.float64))

        mask = np.asarray(mask, bool)
        self.add(prefix + "code_gap", d("tau"), mask)
        self.add(prefix + "doppler_gap", d("doppler"), mask)
        dp = np.mod(d("phase") + np.pi, _TWO_PI) - np.pi
        self.add(prefix + "phase_gap", np.abs(dp), mask)
        self.add(prefix + "cn0_gap", d("cn0"), mask)

    def signs(self, got, want, mask):
        self.symbols += int(((np.asarray(got) < 0)
                             != (np.asarray(want) < 0))[mask].sum())


def start_fields(ctx, ref: ReferenceEngine) -> dict:
    """The reference's own state at the start of a pass: every channel
    pulled in at the truth, as the program's set-up does it."""
    s = ref.fields()
    for t in ctx.truth:
        ref.activate(s, t.ch, t.ch, t.delay, t.doppler)
        if ctx.cell.config["extended"]:
            ref.enable_extended(s, t.ch, t.bit0)
        s["rem_carr_phase_rad"][t.ch] = t.phase
    return s


def compare_start(ctx, ref: ReferenceEngine, numbers: Numbers) -> None:
    """The program's state at the start of a pass against the reference's
    own activation at the same truth."""
    want = ref.pack(start_fields(ctx, ref), ctx.span)
    got = ref.pack(state_fields(ctx.init_state), ctx.span)
    numbers.start += sum(int((g != w).sum()) for g, w in zip(got, want))


def follows(key, prev) -> bool:
    """Whether compared segment `key` (pass, segment) comes right after
    the walker's last one, `prev` (its key and exit rows, or None)."""
    return prev is not None and prev[0] == (key[0], key[1] - 1)


def walk_from(ctx, ref: ReferenceEngine, key, st_in, prev):
    """The rows a compared segment is walked from: at the start of the
    first pass the walker's own activation at the truth; right after a
    compared segment of the same pass (`follows`) the walker's own exit
    of it; else the state the program entered the segment with."""
    if key == (0, 0):
        return ref.pack(start_fields(ctx, ref), ctx.span)
    if follows(key, prev):
        return prev[1]
    return ref.pack(state_fields(st_in), ctx.span)


def gap_rows(ctx, key, prev):
    """How many of a compared segment's first rows give gaps: every row
    (None), or where the cell's limits set `head_epochs`, the first that
    many of a segment walked from the program's state and none of one
    walked from the walker's own (`walk_from`).  A head: where a float32
    code index at a chip boundary rounds to the other chip on one side,
    the closed loops then part for hundreds of epochs by as much as the
    control's do, so only the epochs before that are compared."""
    head = ctx.cell.limits.get("head_epochs")
    if head is None:
        return None
    return 0 if key != (0, 0) and follows(key, prev) else int(head)


def rows_state(fst, ist, span: int) -> dict:
    """The loop-state fields that the check reads, from a walk's rows
    (starts rebased by the span, as the program's state is)."""
    f, i = fst.numpy(), ist.numpy()
    return {"active": i[tc.I_ACTIVE] > 0,
            "start": i[tc.I_START] - span,
            "rem_code_phase_samples": f[tc.F_REM_CODE],
            "carrier_doppler_hz": f[tc.F_DOPPLER],
            "rem_carr_phase_rad": f[tc.F_REM_CARR],
            "cn0_last": f[tc.F_CN0]}


def next_rows(fst, ist, slot, span: int):
    """A walk's exit rows as the start of the segment after it: the starts
    rebased by the span, as the program hands its state on."""
    ist = ist.clone()
    ist[tc.I_START] -= span
    ist[tc.I_LIMIT] = span
    return fst, ist, slot


def rows_outputs(ref, of, oi, oc) -> dict:
    """A walk's rows as the harvest hands them over (TrackOutputs' fields,
    the loop-state rows held between the decimated picks)."""
    K = ref.cfg.n_taps
    of, oi, oc = of.numpy(), oi.numpy(), oc.numpy()
    D = 4
    while ref.E % D and D > 1:
        D //= 2
    held = np.repeat(of[D - 1::D], D, axis=0)
    return {"valid": of[:, tc.O_VALID] > 0.5,
            "active": of[:, tc.O_ACTIVE] > 0.5,
            "start": oi[:, 0], "cur_len": oi[:, 1],
            "correlators": (oc[:, :K] + 1j * oc[:, K:]).transpose(0, 2, 1),
            "rem_code_phase_samples": of[:, tc.O_REM_CODE],
            "carrier_doppler_hz": held[:, tc.O_DOPPLER],
            "rem_carr_phase_rad": held[:, tc.O_REM_CARR],
            "cn0_dbhz": held[:, tc.O_CN0]}


def compare_exit(got: dict, want: dict, half_epoch: float,
                 numbers: Numbers) -> None:
    """The state a segment was left in against the reference's, both as
    state fields (`state_fields`, `rows_state`)."""
    act_g = np.asarray(got["active"]).astype(bool)
    act_r = np.asarray(want["active"]).astype(bool)
    numbers.flags += int((act_g != act_r).sum())
    far = np.abs(np.asarray(got["start"], np.int64)
                 - np.asarray(want["start"], np.int64)) >= half_epoch
    numbers.flags += int(far.sum())

    def loop(s):
        return {"tau": np.asarray(s["start"]).astype(np.float64)
                + s["rem_code_phase_samples"],
                "doppler": s["carrier_doppler_hz"],
                "phase": s["rem_carr_phase_rad"], "cn0": s["cn0_last"]}

    numbers.loop("exit_", {k: v[None] for k, v in loop(got).items()},
                 {k: v[None] for k, v in loop(want).items()},
                 (act_g & act_r)[None])


def _gap(got_c: np.ndarray, want_c: np.ndarray, prompt: np.ndarray,
         mask: np.ndarray) -> np.ndarray:
    """Per row [rows, C]: the widest tap gap over the channel's median
    reference prompt magnitude.  got_c / want_c [rows, C, K] complex,
    prompt [rows, C] complex, mask [rows, C] (the rows of the median)."""
    mag = np.abs(prompt)
    scale = np.array([np.median(mag[mask[:, c], c]) if mask[:, c].any()
                      else 1.0 for c in range(mask.shape[1])])
    scale = np.where(scale > 0, scale, 1.0)                 # [C]
    return np.abs(got_c.astype(np.complex128)
                  - want_c.astype(np.complex128)).max(axis=-1) / scale


def compare_epochs(ref, got: dict, want: dict, numbers: Numbers,
                   gap_rows=None) -> None:
    """A harvested segment's per-epoch rows against the reference's, both
    as the harvest hands them over (`rows_outputs`): the flags and signs of
    every row, the gaps of the first `gap_rows` (None: every row)."""
    numbers.flags += int((got["valid"] != want["valid"]).sum())
    numbers.flags += int((got["active"] != want["active"]).sum())
    P = ref.cfg.prompt_index
    numbers.signs(got["correlators"][..., P].real,
                  want["correlators"][..., P].real,
                  want["valid"] & got["valid"])
    if gap_rows is not None:
        got = {k: v[:gap_rows] for k, v in got.items()}
        want = {k: v[:gap_rows] for k, v in want.items()}
    both = want["valid"] & got["valid"]
    numbers.add("corr_gap", _gap(got["correlators"], want["correlators"],
                                 want["correlators"][..., P], both), both)

    def loop(o):
        return {"tau": o["start"].astype(np.float64) + o["cur_len"]
                + o["rem_code_phase_samples"].astype(np.float64),
                "doppler": o["carrier_doppler_hz"],
                "phase": o["rem_carr_phase_rad"], "cn0": o["cn0_dbhz"]}

    numbers.loop("", loop(got), loop(want), both)


def compare_symbols(got: dict, want: dict, N: int,
                    numbers: Numbers) -> None:
    """A segment's symbol-grid outputs against the reference's reduction
    of its own rows."""
    for f in ("vcount", "n_valid", "active"):
        numbers.flags += int((np.asarray(got[f]) != want[f]).sum())
    mask = (got["vcount"] > 0) & (want["vcount"] > 0)
    m_g = got["mean_i"] + 1j * got["mean_q"]
    m_r = want["mean_i"] + 1j * want["mean_q"]
    numbers.add("corr_gap", _gap(m_g[..., None], m_r[..., None], m_r,
                                 mask), mask)
    numbers.signs(got["mean_i"], want["mean_i"],
                  (got["vcount"] == N) & (want["vcount"] == N))

    def loop(o):
        return {"tau": o["start"].astype(np.float64) + o["frac"],
                "doppler": o["carrier_doppler_hz"],
                "phase": o["rem_carr_phase_rad"], "cn0": o["cn0_dbhz"]}

    numbers.loop("", loop(got), loop(want), mask)


def judge(numbers: dict, limits: dict):
    """(each compared number beside its limit, the numbers the cell does
    not compare); a limit without a number is an error in the cell's
    files."""
    lim = limits["limits"]
    missing = sorted(set(lim) - set(numbers))
    if missing:
        raise KeyError(f"no number {missing}")
    return ({k: {"value": numbers[k], "limit": float(lim[k])} for k in lim},
            {k: v for k, v in numbers.items() if k not in lim})
