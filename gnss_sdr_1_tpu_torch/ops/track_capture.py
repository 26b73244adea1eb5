"""Capture-level tracking: the chunk correlator and the tracking chain for
every chunk of a capture segment.

On the card one C call (`track_capture_launch` in csrc/track_chain.cu)
enqueues `chunk_corr` then `track_chain` for each of the `n_chunks` chunks
on PyTorch's current stream: the chain writes its per-epoch rows straight
into the capture-wide outputs at the chunk's epoch offset and its state
into one of two ping-pong buffers, which the next chunk's correlator and
chain read.  Nothing crosses to the host between chunks (the sample limit
is fixed for the call), so Python makes one call per segment.  On the CPU
the plain version runs the same chunk loop in Python with the two plain
kernels.

Signature of `track_capture` / `track_capture_plain`:
    (chain_spec, corr_spec, n_chunks, samples [n_samp] complex64,
     rows [n_slots, QW] f32, slot [C] i32, sec_rows [sec_len, C] f32,
     fst [SF, C] f32, ist [SI, C] i32)
 -> (out_f [n_chunks*E, 7, C] f32, out_i [n_chunks*E, 2, C] i32,
     out_corr [n_chunks*E, 2K, C] f32, fst' [SF, C] f32, ist' [SI, C] i32)
"""

from __future__ import annotations

import ctypes

import torch

from . import chunk_corr as cc
from . import track_chain as tc

def _outputs(chain_spec: tc.ChainSpec, n_chunks: int, dev):
    cap, C, K = n_chunks * chain_spec.E, chain_spec.C, chain_spec.K
    return (torch.empty((cap, tc.N_OROWS, C), dtype=torch.float32,
                        device=dev),
            torch.empty((cap, 2, C), dtype=torch.int32, device=dev),
            torch.empty((cap, 2 * K, C), dtype=torch.float32, device=dev))


def track_capture_plain(chain_spec: tc.ChainSpec, corr_spec: cc.CorrSpec,
                        n_chunks: int, samples, rows, slot, sec_rows, fst,
                        ist):
    """The chunk loop in plain torch ops (any device)."""
    E = chain_spec.E
    out_f, out_i, out_corr = _outputs(chain_spec, n_chunks, samples.device)
    bank_t = cc.replica_bank(corr_spec, rows, slot)
    for i in range(n_chunks):
        zr, zi, s_reg, step0 = cc.correlate_plain(corr_spec, samples, bank_t,
                                                  fst, ist)
        of, oi, oc, fst, ist = tc.chain_plain(chain_spec, zr, zi, s_reg,
                                              step0, sec_rows, fst, ist)
        out_f[i * E:(i + 1) * E] = of
        out_i[i * E:(i + 1) * E] = oi
        out_corr[i * E:(i + 1) * E] = oc
    return out_f, out_i, out_corr, fst, ist


def _check_specs(chain_spec: tc.ChainSpec, corr_spec: cc.CorrSpec,
                 n_chunks: int):
    if (chain_spec.E, chain_spec.LW, chain_spec.C) != (
            corr_spec.E, corr_spec.LW, corr_spec.C):
        raise ValueError("chain and correlator specs disagree on E, LW, C")
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")


def track_capture_cuda(chain_spec: tc.ChainSpec, corr_spec: cc.CorrSpec,
                       n_chunks: int, samples, rows, slot, sec_rows, fst,
                       ist):
    """Enqueue both kernels for every chunk with one C call."""
    from ._build import library

    _check_specs(chain_spec, corr_spec, n_chunks)
    cc.check_inputs(corr_spec, samples, rows, slot, fst, ist,
                    tc.n_frows(chain_spec.K))
    tc.check_tensor(sec_rows, "sec_rows", (chain_spec.sec_len, chain_spec.C),
                    torch.float32)
    C, E, LW = corr_spec.C, corr_spec.E, corr_spec.LW
    dev = samples.device
    out_f, out_i, out_corr = _outputs(chain_spec, n_chunks, dev)
    fst_ab = [torch.empty_like(fst), torch.empty_like(fst)]
    ist_ab = [torch.empty_like(ist), torch.empty_like(ist)]
    zr = torch.empty((C, E, LW), dtype=torch.float32, device=dev)
    zi = torch.empty_like(zr)
    s_reg = torch.empty((C, E), dtype=torch.int32, device=dev)
    step0 = torch.empty((C,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().track_capture_launch(
        n_chunks, samples.data_ptr(), samples.shape[0], rows.data_ptr(),
        slot.data_ptr(), sec_rows.data_ptr(), fst.data_ptr(), ist.data_ptr(),
        fst_ab[0].data_ptr(), ist_ab[0].data_ptr(), fst_ab[1].data_ptr(),
        ist_ab[1].data_ptr(), zr.data_ptr(), zi.data_ptr(), s_reg.data_ptr(),
        step0.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
        out_corr.data_ptr(), ctypes.addressof(cc.corr_params(corr_spec)),
        ctypes.addressof(tc.chain_params(chain_spec)), stream)
    if err != 0:
        raise RuntimeError(f"track_capture launch failed: CUDA error {err}")
    cc.launches += n_chunks
    tc.launches += n_chunks
    last = (n_chunks - 1) % 2
    return out_f, out_i, out_corr, fst_ab[last], ist_ab[last]


def track_capture(chain_spec: tc.ChainSpec, corr_spec: cc.CorrSpec,
                  n_chunks: int, samples, rows, slot, sec_rows, fst, ist):
    """Track every chunk of a segment where the inputs lie: one C call
    enqueuing both kernels per chunk for CUDA tensors, the plain chunk loop
    for CPU tensors."""
    devs = {t.device.type for t in (samples, rows, slot, sec_rows, fst, ist)}
    if devs == {"cuda"}:
        return track_capture_cuda(chain_spec, corr_spec, n_chunks, samples,
                                  rows, slot, sec_rows, fst, ist)
    if devs == {"cpu"}:
        _check_specs(chain_spec, corr_spec, n_chunks)
        return track_capture_plain(chain_spec, corr_spec, n_chunks, samples,
                                   rows, slot, sec_rows, fst, ist)
    raise ValueError(f"track_capture inputs must all lie on one device "
                     f"type, got {sorted(devs)}")
