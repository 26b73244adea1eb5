#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA receiver on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --e2e-seeds 1234,1,2 --e2e-cpu card:1234,numpy:1

The second form runs phase 5's receiver alone over the e2e capture made
with other noise (the card's and numpy's, one capture per seed; on the CPU
too for the captures named), prints fixes, first-fix time and median 3D
error a run, holds no bar, and ends without the lines below.

Phases (one line each, with times):
  1. the card (nvidia-smi name and power limit) and the kernel build (one
     nvcc for each library and stage build, started together: the
     tracking library, the KF library, the gather walk's, which holds the
     one-epoch multicorrelator too, and the KF, gather and multicorrelator
     stage builds), with ptxas' registers, stack frame and spills of every
     kernel instance (the chain's instances may use no local memory, the
     KF, gather and multicorrelator kernels' may spill nothing);
  2. both CUDA kernels against their plain torch versions on the card, at
     the main path's shapes (E=16, LW=68, NW=4136, C=12, K=3), on random
     inputs and on the inputs of a real chunk taken mid-track: the chunk
     correlator (chunk_corr) and the tracking chain (track_chain), each
     timed (device time per launch from the profiler, the plain version,
     and for the correlator the torch.bmm pair it replaces, the cluster of
     CTAs a channel takes, its tiles and TF32 passes, and three bounds:
     bytes, the lag products at the float32 rate, and its TF32 passes at
     the tensor cores' rate); then the
     capture entry (both kernels over three chunks in one call) against
     the plain chunk loop on the CPU; the same three checks (untimed) at
     the engine's shapes for 2.046 Msps (phase 7's rate) and 2.6 Msps
     (gps_l1_kalman.conf's, 2.54 samples per chip); the same three checks
     at the Galileo E1 receiver's shape (K=5 VEML taps, E=16, C=8,
     4.0 Msps: NW=16045, LW=69), timed like the first, and once more
     (untimed) at 8.184 Msps, where every CTA of a channel's cluster walks
     its share of the 4 ms window (NW=32783) in several shared-memory
     tiles; and the same three checks,
     timed, at the GPS L5 shape (12.5 Msps, C=6, NH10), the Galileo E5a
     shape (12 Msps, C=6, CS20), the BeiDou B1I shape (5 Msps, C=8, the
     0.2-chip correlator, NH20) and the B3I shape (12.5 Msps, C=6, NH20)
     on chunks of real L5/E5a/B1I/B3I engines whose
     channels wipe the secondary code from a non-zero code index (the
     chain's secondary-code instances; over the capture entry's three
     chunks the index crosses chunk seams); the same three checks, timed,
     at a GLONASS L1 shape (6.625 Msps, C=5, the FDMA carrier bias of
     k = -5, -2, 0, 1, 5 in both kernels: |k| = 5 is 2.81 MHz) and at the
     GPS L2C shape (3 Msps, C=6, the 20 ms window of ~60,000 samples
     walked in 4 tiles); and each of the chain's 16 template instances
     <K, ORDER, SEC_DATA, HAS_SEC> on the E1 (K=5) and L5 (K=3) chunks,
     one line each, and their every output on the inputs recorded in
     tests/data/chain_instances.npz held bit for bit to the digests the
     chain kernel gave on them before its closure was split;
     then the generator on the card held to the numpy one on a noiseless
     20 ms stretch of every capture the script makes on the card;
 2b. the KF block kernel (kf_block) against its plain version on the CPU,
     two 40 ms blocks a launch from freshly activated channels: GPS at 12
     channels and 4.092 Msps with orders 2 and 3 and the NIW covariance
     off and on, 2.6 Msps with 8 channels (gps_l1_kalman.conf's rate),
     Galileo E1B at 8 channels and 4 Msps in the virtual half-chip basis,
     L2C at 2.046 Msps (40,926-sample epochs), GPS on 1 channel and on 20
     (18 active: the CTAs of the cluster take channels in rounds); timed
     at the GPS, 2.6 Msps, E1B, 1- and 20-channel shapes (device time per
     one-block launch from the profiler, the plain version's on the card,
     the bound, the cluster size, threads per CTA, shared memory and
     prefetch); at the GPS shape also the engine's 25-block launch in us
     per epoch, and the same launch through the KF_BLOCK_STAGES build (a
     second nvcc of kf_block.cu): the share of an epoch spent in the
     barrier and m, the correlation, the reduction and the update on
     CTA 0, and the serial floor of a block (its epochs times one update
     and one barrier);
 2c. the gather DLL/PLL walk (gather_block) against its plain version on
     the CPU over 80 ms (two 40 ms blocks) of channels tracked 50 ms from
     the truth: GPS at 12 channels, Galileo E1B (K=5), L5 with NH10, E5a
     with CS20 and B1I with NH20 (the wipe on from a non-zero index),
     GLONASS with FDMA biases to 2.81 MHz, L2C (no prefetch), GPS on 1
     channel and on 20 (18 active); the 16 template instances on the GPS
     and E1B cases; timed per one-block launch (device ms from the
     profiler, the plain version's on the card, the bound, the cluster
     geometry; CUDA events, the profiler's device time beside them), at
     GPS also the receiver's 1 s segment launch in us per epoch and the
     same launch through the GATHER_BLOCK_STAGES build (a second nvcc of
     gather_block.cu): the exchange of m, the correlation, the reduction
     and the closure of an epoch on CTA 0 (the closure's state-only part
     beside them), in order, and the
     serial floor of a 40 ms block; then the one-epoch multicorrelator
     (multicorrelate_cuda, a cluster of CTAs a channel) against the plain
     multicorrelate on the CPU on real windows at K = 3 and 5 and in its
     four instances (K 3 and 5, orders 2 and 3) at C = 1, 12 and 20, with
     n_valid < N and a 1e5-rad phase, the per-channel arguments by value
     and by pointer bit for bit alike, the order-3 instance at a zero
     rate bit for bit the order-2 one, from an odd first sample bit for
     bit; timed at C = 1, K = 3 at 4,094 and 2,046 samples (the kernel's
     device time by its name, any other kernel and copy a call, the host
     time a call, an empty kernel of the same geometry), and through the
     MC_STAGES build (a third nvcc of gather_block.cu): the spans of a
     CTA and thread 0's cycles a sample with parts of the body left out;
 2d. the symbol-grid kernel (symbol_slots) against symbol_slots_plain on
     the card, bit for bit (the floats as int32, so zeros' signs count),
     through both walks' libraries, one launch a call: the GPS receiver's
     1 s segment (cap 1,008, C=8, N=20; cap 1,004, C=12), a cap not a
     multiple of N with channels that drop, never track or track one
     epoch, and the E1B receiver's (cap 252, N=1, K=5, C=4 and 8); timed
     at the GPS and E1B C=4 shapes (device time by name, CUDA events
     back to back, the plain version, the bytes bound); and, in every
     counted run of the phases below (each receiver, phase 4's engine,
     phase 34's shards), its launches == the symbol-grid calls on the
     card, the first call of each shape held bit for bit to the plain
     version on the same rows;
 2e. the stream front end's kernel (xlate_fir: decode, frequency-
     translating FIR, decimation, rotation, scale in one launch) against
     xlate_fir_plain on the CPU at the NSR cell's segment (20.5 M real
     2-bit samples, 65 taps, D = 8, the conf's IF) and the GPS ishort
     cell's (Direct_Resampler 2:1), as two segments of a stream ~10 h in,
     the seam bit for bit one launch's; timed (device time by name, CUDA
     events back to back, the plain version on the card, the bound);
  3. batched PCPS acquisition of 12 PRNs (detections, FFTs/s), held to the
     same acquisition run on the CPU;
  4. the tracking engine: 12 channels over a 15 s capture at 4.092 Msps
     (made on the card, as the captures of phases 5, 10 and 12-18 are;
     RTF, valid epochs, each kernel's launches == chunks);
  5. the receiver end to end — the main path: 12 satellites, 30 s, live
     LNAV, PVT every 100 ms, the capture preloaded to the card (e2e RTF,
     fixes, median 3D error against the scenario truth, each kernel's
     launches == chunks);
  6. the conf-file CLI (`python -m gnss_sdr_1_tpu_torch`, run in-process)
     on phase 5's capture written as an `ishort` file: File_Signal_Source,
     Pass_Through, 12 channels, DLL/PLL (fixes and median 3D error from
     position.geojson, all seven output files, launches == chunks);
  7. the CLI on the same capture mixed up to a 420 kHz IF: the
     Freq_Xlating_Fir_Filter conditioner on the card decimating to
     2.046 Msps (held to the same FrontEnd on the CPU over the first
     0.5 s), then both kernels at that rate;
  8. the CLI with GPS_L1_CA_KF_Tracking on phase 6's file (RTF at real
     time or faster, fixes, median 3D error, KF epochs, one kf_block
     launch per engine call, kf_block's device time per epoch over the
     run from CUDA events around its launches), the kernel launches per
     KF epoch of one
     25-block engine call (<= 0.1, counted in a CUDA graph captured from
     it) and its device time per epoch (CUDA events), and
     conf/gps_l1_kalman.conf as written (8 channels, NIW on) over the e2e
     scenario made on the card at its 2.6 Msps, as a gr_complex file;
  9. the acquisition strategies on the card, each held to the same call
     on the CPU (detections, Doppler bins, delays within 1 sample,
     statistics within 1e-4 relative, ms per call): PCPS with the
     two-period window, QuickSync (fold 2), CCCWSR, 8 ms and Tong on
     phase 10's Galileo E1 capture; Tong, fine-Doppler and QuickSync on
     phase 3's GPS capture; the E5a CAF core on a seeded random input;
 10. the Galileo E1B receiver end to end: 8 satellites on 8 channels,
     30 s at 4.0 Msps (not commensurate with the 2.046 MHz sinBOC rate),
     48 dB-Hz, I/NAV word cycle 5,1,2,3,4, the capture preloaded to the
     card (RTF, ephemerides, fixes, median 3D error, each kernel's
     launches == chunks);
 11. the CLI on both Galileo E1 confs over phase 10's capture written as
     a gr_complex file: conf/galileo_e1_gr_complex.conf with --fs and
     --channels set to the capture's 4.0 Msps and 8 satellites, and
     conf/galileo_e1_quicksync.conf as written;
 12. the GPS L5 receiver end to end: 6 satellites, 25 s at 12.5 Msps,
     48 dB-Hz, CNAV with NH10 (tests/test_system_l5.py's scenario widened
     from 5 to 6 satellites), the capture generated on the card (the
     generator held to the numpy one on a noiseless 20 ms stretch) and
     preloaded (RTF, CNAV ephemerides, fixes, median 3D error, each
     kernel's launches == chunks, the chunks run with the NH10 wipe on);
 13. the Galileo E5a receiver with the CAF acquisition: 6 satellites, 55 s
     at 12 Msps, F/NAV with CS20 (the same system test's E5a scenario,
     widened), as phase 12;
 14. the CLI on conf/gps_l5.conf and conf/galileo_e5a.conf over those
     captures written as gr_complex files (each file deleted after its
     runs): the L5 conf as written; the E5a conf as written (its PCPS-scale
     threshold acquires nothing under the CAF's statistic: exit 0 without a
     fix) and with the threshold and the pull-in PLL the CAF needs;
 15. the GLONASS L1 receiver with FDMA: tests/test_system_glonass.py's 5
     slots (k = -2..2), 20 s at 4.092 Msps, at its bars (tracked slots,
     GNAV ephemerides equal to the broadcast truth, fixes, median 3D
     error), each kernel's launches == chunks, the chunks run with a
     non-zero FDMA bias; then with 5 s segments (what the pull-in rule
     costs: segments and RTF);
 16. MultiReceiver, GPS L1 C/A + Galileo E1B groups on one stream
     (tests/test_system_mixed.py: 4 + 3 satellites, 30 s at 4 Msps) with
     one joint PVT at that test's bars; launches == chunks per group (the
     K=3 and K=5 chain instances over one capture);
 17. MultiReceiver, GPS L1 + L2C groups on two streams (the same test's
     dual-band case: 4 satellites, 55 s at 2.046 Msps) at its bars;
     launches == chunks per group; the L2C group alone at 1 s and 5 s
     segments (what the pull-in rule costs);
 18. the CLI on hybrid_ishort.conf and multisource_hybrid_ishort.conf
     (phase 16's capture as an ishort file), glonass_l1_gps_l1_ibyte.conf
     (GPS and a GLONASS slot at k = 0, 6.625 Msps ibyte) and
     gps_l2c_ibyte.conf (3 Msps ibyte) as written, each file deleted after
     its run (the joint runs: the `Mixed-constellation run:` line, joint
     fixes on both systems, four position files; the hybrid confs at
     phase 16's bars; the GLONASS conf's R measurements all the capture's
     one satellite, which its k = 0 channels track under several PRNs).
 19. the BeiDou B1I receiver end to end: 8 D1 satellites (PRNs 6-13),
     30 s at 5 Msps (bds_b1i_ibyte.conf's rate), 48 dB-Hz, NH20 on every
     1 ms code period (tests/test_system_beidou.py's scenario widened from
     5 satellites), at that test's bars (ephemerides of system C with
     sqrt_a within 2e-5 of the truth, fixes, median 3D error and mean-bias
     norm under 5 m), each kernel's launches == chunks, the chunks run with
     the NH20 wipe on;
 20. the CLI on conf/bds_b1i_ibyte.conf as written over phase 19's
     capture written as an ibyte file, at phase 19's bars, and the RINEX
     C rows it writes;
 21. the BeiDou B3I receiver: 6 D1 satellites, 30 s at 12.5 Msps, as
     phase 19;
 22. the Galileo E1B receiver with the KF tracker (virtual basis) on
     phase 10's capture made again on the card: every channel held within
     25 Hz of the truth Doppler, ephemerides, fixes, the median 3D error
     under one chip, kf_block launches per block and its device time per
     epoch;
 23. phase 5's receiver with correlator='gather' over phase 5's capture
     (run right after phase 5): fixes and median 3D error at phase 5's
     bars, RTF, gather_block launches == capture segments, its device us
     per epoch (CUDA events around every launch);
 24. tests/test_system_galileo.py's 5-satellite E1B scenario (18 s at
     4 Msps, numpy's noise made on the card) and
 25. tests/test_system_beidou.py's 5-satellite B1I scenario (24 s at
     4 Msps), each through that test's receiver on the gather path at its
     bars (median 3D error and mean-bias norm under 5 m), where both
     packages' chunked paths give 10.05 m and 33.82 m;
 26. conf/gps_l1_ishort.conf with Tracking_1C.correlator=gather added, its
     resampler set to phase 6's file (4.092 -> 2.046 Msps, 12 channels),
     through the CLI at phase 6's bars (run after phase 8);
 27. the TCP connector (track/tcp_connector.py) on
     tests/test_tcp_connector.py's scenario, its correlation on the card
     (one multicorrelate launch per epoch), at that test's bars; an
     epoch's wall split by the tracker's stamps (the correlator call, the
     readback, the JSON write and flush, the wait for the reply, the NCO;
     mean and p90); 300 epochs held to the same tracker on the CPU; 50
     epochs profiled: no host-to-device copy and no kernel but the
     multicorrelator; the 1000 epochs again with the controller in a
     Python process of its own (the same rows; its wall and split);
 28. the streaming receiver (Receiver.process_stream) on phase 6's ishort
     file as raw int16 I/Q in 0.1 s blocks, 1 s segments, the PVT monitor
     on a localhost UDP socket: >= 60 fixes at a median 3D error < 5 m,
     phase 5's fixes over the stream's span solved at the same epochs (the
     stream solves back over ~2 s of observables history where process()
     holds ~10 s, so its first fix comes later), PVT datagrams == fixes,
     launches == chunks, the bytes staged to the card per signal second,
     the unpack's device time for one segment, wall and RTF beside phase
     5's process(), and the share of the harvest wall during which the
     next segment was on the device (CUDA events around each segment's
     launch against host timestamps around each harvest); then the same
     capture nibble-packed to 2 bits (tests/test_streaming.py's bar: >= 20
     fixes, median < 8 m) and the ishort stream with correlator='gather'
     (gather_block launches == segments, >= 60 fixes, median < 5 m);
 29. an rtl_tcp server on 127.0.0.1 (a thread) serving phase 5's capture
     as unsigned 8-bit I/Q; io.network.RtlTcpSignalSource reads it in
     0.1 s blocks into process_stream (>= 60 fixes, median 3D error
     < 5 m, the count printed beside phase 28's);
 30. phase 5's receiver over the first 12 s of phase 5's capture,
     checkpoint, resume_from on the card (and on the CPU: the same tracking
     state), the rest of the capture: >= 30 fixes, the mean of the last 10
     within 1 m of phase 5's;
 31. A-GNSS: phase 5's scenario made at 2.046 Msps and written as ishort,
     conf/gps_l1_supl_assisted.conf (12 channels) through the CLI with
     --supl from a SuplServer on 127.0.0.1 (the scenario's ephemerides, a
     reference location 1 km off, the capture's TOW), cold, and with
     --assist on a save_assistance JSON: the assisted runs assign the cold
     run's satellites, each acquisition Doppler within a Doppler step of
     the cold run's, fixes no fewer than the cold run's less 2 %, median
     3D error < 5 m; both programs' Doppler bins and ms a call on the same
     samples; then a hot start (Receiver.load_ephemerides of the cold
     run's brdc.rnx read back by read_rinex_nav) that fixes first;
 32. conf/gps_l1_ishort.conf with PVT.positioning_mode=PPP_Static on
     phase 6's file to 25 s (--max_s; ~610 epochs of observables), with
     broadcast orbits and with PVT.sp3_file (an SP3
     of the scenario's orbits, sp3_from_broadcast and write_sp3): a valid
     PPP line each, solve_ppp_batch's wall, epochs, arcs, sigma0 and the
     3D error;
 33. a base 500 m from the rover under the same orbits (30 s at
     4.092 Msps, made on the card) through the CLI, whose
     observables.rtcm (MT1005 + MSM7) feeds the rover's CLI on phase 6's
     file to 25 s with --base_obs, PVT.positioning_mode=DGNSS (the batch
     solver) and Kinematic (the EKF): a valid baseline each, its length against
     the truth, fixed or float, the ratio and the wall;
 34. the channel-sharded receiver (gnss_sdr_1_tpu_torch.parallel) over a
     mesh of every visible device when there are two or more, else over 2
     and 4 logical shards of cuda:0, each on its own stream (the line says
     which): phase 4's engine (12 channels, 15 s, chunked) by
     track_capture and track_capture_symbols, and 10 s of phase 5's
     capture on the gather walk, each equal to the unsharded engine on the
     same card (np.array_equal on every output row and the final state),
     each shard's kernel launches == its chunks (chunked) or its segments
     (gather);
     the PCPS grid of 32 PRNs with its PRN rows sharded, equal to the
     unsharded grid; phase 7's IF conditioner over time blocks joined by
     the halo exchange, equal to one device's; a profile of one
     sharded 1 s segment holding no peer copy and no NCCL kernel between
     its first launch and its last harvest; and the channel-samples per
     second of the chunked engine at 1, 2 and 4 shards of 12 channels
     each (3 s spans), the weak-scaling efficiency against one shard;
 35. process_stream through the conf's front end, each receiver built
     from its conf as written: conf/gps_l1_nsr.conf on phase 5's
     satellites made at 20.48 Msps as NSR's real 2-bit IF (the conf's
     Freq_Xlating_Fir_Filter, 65 taps, D = 8), conf/gps_l1_ishort.conf on
     them at 4 Msps as ishort (Direct_Resampler 2:1), 8 s each at 50
     dB-Hz;
     xlate_fir launches == segments and the chunked kernels' == chunks,
     the counters set to 0 just before each run; the first segment's
     conditioned samples held to xlate_fir_plain (ishort bit for bit, NSR
     within 2 float32 ulps, its bit-for-bit share reported); every
     assigned channel on a visible satellite, at least 4 bit-synced.
Then one JSON line describing every kernel (the chunked kernels'
launches summed over phases 5-7, 10-21 and 28-35, the KF kernel's over
phases 8 and 22, the gather walk's over 23-26, 28 and 34, the multicorrelator's
over 27, the symbol grid's over every counted run, the stream front end's
over 35, each read just after its run), the nvidia-smi line, and
last
{"ok": true, "device": {...}}.  Any failed check raises: the script exits
non-zero and prints no result.  Without a CUDA device it exits non-zero at
once.  The short captures of phase 2's kernel checks are cached in
chip_smoke_cache/ (git-ignored); the full report (per-row kernel diffs, per-PRN acquisition results) goes to
`--out` (default chip_smoke_cache/) as chip_smoke_report.json.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import pathlib
import re
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
FS = 4.092e6
ENGINE_S = 15.0       # engine phase capture (bench.py DURATION_S)
E2E_S = 30.0          # receiver phase capture (bench.py E2E_DURATION_S)
MIN_FIXES = 140
CACHE = ROOT / "chip_smoke_cache"
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# the TF32 tensor-core rate (dense), for the correlator's passes
PEAK_TF32_S = 495e12
# float32 operations per (epoch, channel) of the chain: tap reads ~45,
# rotation ~20, wipe/accumulate ~12, discriminators ~60, PLL ~15, DLL ~30,
# NCO ~15, CN0/lock ~25, ledger ~10, with each transcendental counted as
# ~8 — an estimate; the chain is bound by neither bytes nor operations
OPS_PER_EPOCH_CHANNEL = 300
# float32 operations per wiped sample of the correlator besides the lag
# products: phase (multiply, add), the complex rotation (4 multiplies,
# 2 adds); the sine and cosine are not counted
WIPE_OPS_PER_SAMPLE = 8
# chunks of the capture entry's check in phase 2 (the sample limit of the
# mid-track segment, 40 ms, ends inside the third)
CAPTURE_CHUNKS = 3
# phase 2: the chain's 16 instances on fixed inputs (.npz) and the SHA-256
# digests of every output that the chain kernel gave on them before its
# closure was split around the gather walk's correlation (.json)
CHAIN_DIGESTS = ROOT / "tests" / "data" / "chain_instances"
# phase 2's extra kernel checks: phase 7's internal rate and
# gps_l1_kalman.conf's (a non-integer number of samples per chip)
CHECK_RATES = (2.046e6, 2.6e6)
# phases 6-8: the capture as the verify recipe writes it (int16 I/Q at
# this scale), the IF of phase 7 and its internal rate (decimation 2)
ISHORT_SCALE = 1500.0
IF_HZ = 420e3
FS_IF = FS / 2
MIN_FIXES_IF = 100
# the KF receiver's bars (tests/test_kf_tracking.py:179-184); phase 8's
# run of conf/gps_l1_kalman.conf at its rate; the blocks of one receiver
# segment (reacq_interval_blocks) in phase 8's profile
MIN_FIXES_KF = 10
FS_KALMAN = 2.6e6
KF_SEG_BLOCKS = 25
OUTPUT_FILES = ("position.kml", "position.gpx", "position.geojson",
                "position.nmea", "observables.rnx", "brdc.rnx",
                "observables.rtcm")
# phases 2 and 9-11: the Galileo E1B receiver's scenario
# (tests/test_system_galileo.py scaled to 8 satellites) and its bars
FS_E1 = 4.0e6
E1_S = 30.0
E1_PRNS = tuple(range(1, 9))
E1_TILED_RATE = 8.184e6
MIN_EPH_E1 = 6
MIN_FIXES_E1 = 10
# phase 22: the E1B KF receiver's channels end within this of the truth
# Doppler (tests/test_kf_tracking.py::test_kf_tracks_boc_signal), and its
# median 3D error under one E1B chip (293 m): the KF's 0.5-chip E-L
# spacing leaves its code loop flat on the sinBOC side lobes, and both
# packages' KF receivers give 98.4 m (8 satellites) and 188.6 m (5) on
# the Galileo system test's 18 s scenario on the CPU (PERF.md)
E1_KF_MAX_DOPPLER_ERR = 25.0
E1_KF_MAX_MEDIAN_M = 300.0
# CCCWSR and 8 ms normalise their peak by F^2 times the input power
E1_THRESHOLDS = {"cccwsr": 8e-4, "8ms": 8e-4}
# phases 2 and 12-14: GPS L5I at conf/gps_l5.conf's rate and Galileo E5a-I
# at conf/galileo_e5a.conf's, 6 satellites each (tests/test_system_l5.py
# widened from 5 to 6 satellites; E5a 5 s longer than its 50 s, which
# leave ~1 s of fixes after the four F/NAV pages)
FS_L5 = 12.5e6
L5_S = 25.0
L5_PRNS = (1, 3, 5, 7, 9, 11)
FS_E5A = 12.0e6
E5A_S = 55.0
E5A_PRNS = (11, 12, 13, 14, 15, 16)
MIN_EPH_SEC = 4
MIN_FIXES_SEC = 10
# the CAF's statistic is its peak over F^2 times the input power (~1e-3 at
# 48 dB-Hz, <= ~4e-4 on noise at the E5a shape), and its Doppler has no
# second step (up to ~200 Hz off): a threshold on that scale and a wide
# pull-in PLL (the narrow loop after secondary sync is the default 12 Hz)
CAF_THRESHOLD = 5e-4
CAF_PLL_BW_HZ = 45.0
# seconds of signal per block of the generator on the card
GEN_BLOCK_S = 1.0
# the captures of phases 3-5 and 10, made on the card with the numpy
# generator's noise (seed 1234): the captures their bars were set on
NUMPY_NOISE_CELLS = ("engine", "e2e", "E1")
# phase 2: the GLONASS shape (one slot at |k| = 5 at 6.625 Msps, 2.81 MHz
# against the +-3.31 MHz band) and the L2C shape (gps_l2c_ibyte.conf's
# 3 Msps, a 20 ms epoch of ~60,000 samples)
FS_GLO_HI = 6.625e6
GLO_CHECK_KS = {1: -5, 2: -2, 3: 0, 4: 1, 5: 5}
FS_L2C = 3.0e6
# phase 15: tests/test_system_glonass.py's scenario and bars
FS_GLO = 4.092e6
GLO_S = 20.0
GLO_T0 = 35995.0            # 25 s into a 30 s GNAV frame
GLO_KS = {1: -2, 2: -1, 3: 0, 4: 1, 5: 2}
MIN_TRACKED_GLO = 4
MIN_EPH_GLO = 4
MIN_FIXES_GLO = 10
MAX_MEDIAN_GLO = 15.0
# phase 16: tests/test_system_mixed.py's GPS L1 + Galileo E1B scenario
FS_MIX = 4.0e6
MIX_S = 30.0
MIX_GPS = (1, 2, 3, 4)
MIX_GAL = (11, 12, 13)
MIN_FIXES_MIX = 10
MAX_MEDIAN_MIX = 5.0
# phase 17: the same test's GPS L1 + L2C dual-band case
FS_DUAL = 2.046e6
DUAL_S = 55.0
DUAL_PRNS = (1, 2, 3, 4)
MIN_EPH_L2C = 3
# phase 18: the GLONASS + GPS conf's capture (GPS and one GLONASS slot at
# k = 0, the frequency channel the conf's group runs every slot at; time
# of day within the first day of the GPS week, where the scenario's
# GLONASS time of day equals GPS TOW) and the L2C conf's, written as ibyte
# files at this scale
GLO_CONF_S = 30.0
GLO_CONF_GPS = (1, 2, 3, 4, 5, 6)
GLO_CONF_SLOT = 7
L2C_CONF_S = 55.0
L2C_CONF_PRNS = (1, 2, 3, 4, 5, 6)
IBYTE_SCALE = 30.0
# phases 2 and 19-21: BeiDou B1I at bds_b1i_ibyte.conf's rate and 8 D1
# satellites (tests/test_system_beidou.py widened from 5), and B3I at
# 12.5 Msps on 6, with that test's bars: ephemerides with sqrt_a within
# 2e-5 of the truth, fixes, the median 3D error and the mean bias
FS_B1I = 5.0e6
B1I_S = 30.0
B1I_PRNS = tuple(range(6, 14))
FS_B3I = 12.5e6
B3I_S = 30.0
B3I_PRNS = tuple(range(6, 12))
MIN_EPH_BDS = 4
MAX_SQRT_A_ERR_BDS = 2e-5
MIN_FIXES_BDS = 10
MAX_MEDIAN_BDS = 5.0
MAX_BIAS_BDS = 5.0
# phases 24-25: the Galileo and BeiDou system tests' scenarios as they
# stand (5 satellites at 4 Msps; E1B 18 s, B1I 24 s), where both packages'
# chunked paths give 10.05 m and 33.82 m median 3D error
FS_SYS = 4.0e6
SYS_E1_PRNS = (1, 2, 3, 4, 5)
SYS_E1_S = 18.0
SYS_B1_PRNS = (6, 7, 8, 9, 10)
SYS_B1_S = 24.0
# phases 28-30: blocks and segments of the stream; tests/test_streaming.py's
# 2-bit bar; the rtl_tcp stream's uint8 counts a unit of phase 5's capture;
# the checkpoint's split, and tests/test_checkpoint_resume.py's bars
STREAM_BLOCK_S = 0.1
STREAM_SEGMENT_S = 1.0
# a stream's fixes: the receiver solves back over the observables history
# it holds once four ephemerides are in (512 points: ~10 s on process()'s
# symbol grid, ~2 s on the 4 ms grid of process_stream's per-epoch
# harvest), so on phase 5's capture the stream's first fix comes ~7 s
# after process()'s and its count is ~80, not ~159; it is held to
# process()'s fixes over the stream's own span (at least this share of
# them at the same epochs) and to this count
MIN_FIXES_STREAM = 60
MIN_SHARE_SAME_EPOCHS = 0.95
MIN_FIXES_2BIT = 20
MAX_MEDIAN_2BIT = 8.0
RTL_SCALE = 30.0
CKPT_SPLIT_S = 12.0
MIN_FIXES_CKPT = 30
MAX_CKPT_DIFF_M = 1.0

# phase 2b: the KF block kernel at the KF paths' shapes: (what, signal,
# fs, channels, active channels, order, bayes_run, timed); two blocks of
# KF_BLOCK_MS a launch; NIW from epoch 10 and in use from epoch 20 in the
# bayes cases, so a block reaches both
KF_BLOCK_MS = 40
KF_BAYES = {"bayes_ptrans": 10, "bayes_strans": 10}
KF_CHECKS = (
    ("GPS", "1C", FS, 12, 12, 2, False, True),
    ("GPS", "1C", FS, 12, 12, 3, False, False),
    ("GPS", "1C", FS, 12, 12, 2, True, False),
    ("GPS", "1C", FS, 12, 12, 3, True, False),
    ("GPS 2.6 Msps", "1C", 2.6e6, 8, 7, 2, True, True),
    ("E1B", "1B", 4.0e6, 8, 8, 2, False, True),
    ("L2C", "2S", 2.046e6, 6, 6, 2, False, False),
    ("GPS C=1", "1C", FS, 1, 1, 2, False, True),
    ("GPS C=20", "1C", FS, 20, 18, 2, False, True),
)
# float32 operations per correlated sample of the KF walk: the phase (2),
# its sine and cosine (~8 each), the wipe (6), three code indices (3 each)
# and three complex accumulations (2 each)
KF_OPS_PER_SAMPLE = 39
# phase 2c: the gather DLL/PLL walk at the receivers' shapes: (what,
# signal, fs, channels, active channels, timed); a launch walks two 40 ms
# blocks; timed per one-block launch
GATHER_WALK_MS = 80
GATHER_CHECKS = (
    ("GPS", "1C", FS, 12, 12, True),
    ("E1B", "1B", FS_E1, 8, 8, True),
    ("L5 NH10", "L5", FS_L5, 6, 6, True),
    ("E5a CS20", "5X", FS_E5A, 6, 6, False),
    ("B1I NH20", "B1", FS_B1I, 8, 8, True),
    ("GLONASS FDMA", "1G", FS_GLO_HI, 5, 5, True),
    ("L2C", "2S", FS_L2C, 6, 6, True),
    ("GPS C=1", "1C", FS, 1, 1, True),
    ("GPS C=20", "1C", FS, 20, 18, True),
)
# float32 operations per correlated sample of the gather walk: as the KF's
# with K code indices and K complex accumulations
GATHER_OPS_PER_SAMPLE = {3: 39, 5: 49}
# phase 2c: the channel counts of the one-epoch multicorrelator's instance
# grid (one, the GPS receiver's 12, 20)
MC_CHECK_C = (1, 12, 20)
# launches of one input through each build, held bit for bit alike
MC_REPEATS = 20
# phase 27: the epochs held to the same tracker on the CPU, and the epochs
# profiled for the copies and kernels an epoch makes
TCP_FS = 2.046e6
TCP_CPU_EPOCHS = 300
TCP_PROFILE_EPOCHS = 50
# phase 31: phase 5's scenario at conf/gps_l1_supl_assisted.conf's rate on
# one channel a satellite (the conf's 8 would leave 4 of the 12 to the
# order of each grid's statistics), the assistance's reference location
# 1 km east of the truth, the fixes the assisted runs may lose against the
# cold run's, and the acquisition calls timed on each grid
FS_AGNSS = 2.046e6
AGNSS_CHANNELS = 12
AGNSS_REF_OFFSET_M = 1000.0
AGNSS_FIX_SHARE = 0.02
AGNSS_ACQ_CALLS = 20
MIN_FIXES_AGNSS = MIN_FIXES
# phases 32-33: the rover's CLI runs stop PPP_RTK_S into phase 6's file.
# Its ephemerides are complete ~23 s in, and the first solve then reaches
# back over ~10 s of observables history, so 25 s give ~610 epochs of
# observables at 50 Hz where 30 s give ~860: the batch PPP took 12.0-13.4 s
# a run on the host over 860 and 5.3-7.1 s over 609 beside an NVIDIA H100
# 80GB HBM3 at 700.00 W, the two baselines ~10 s together over 860.
# Their fix bar: ~110-120 fixes at 10 Hz from ~13 s, halved.  The base
# 400 m east and 300 m north of the rover (500 m), on noise of its own,
# the whole 30 s
PPP_RTK_S = 25.0
MIN_FIXES_PPP_RTK = 60
RTK_BASE_EAST_M = 400.0
RTK_BASE_NORTH_M = 300.0
RTK_BASE_SEED = 99


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=CACHE,
                    help="directory for chip_smoke_report.json")
    ap.add_argument("--e2e-seeds", default=None, metavar="S,S,...",
                    help="in place of the smoke run: phase 5's receiver on "
                    "the card over the e2e capture made with each seed's "
                    "card noise and with its numpy noise (fixes, first-fix "
                    "time, median 3D error; no bar), into e2e_seeds.json")
    ap.add_argument("--e2e-cpu", default="", metavar="card:S,numpy:S,...",
                    help="with --e2e-seeds: also run the port on the CPU "
                    "over these captures")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import gnss_sdr_1_tpu_torch  # noqa: F401  (sets TF32 off)
    from gnss_sdr_1_tpu_torch.ops import _build
    from gnss_sdr_1_tpu_torch.ops import chunk_corr as cc
    from gnss_sdr_1_tpu_torch.ops import gather_block as gb
    from gnss_sdr_1_tpu_torch.ops import kf_block as kb
    from gnss_sdr_1_tpu_torch.ops import multicorrelator as mc
    from gnss_sdr_1_tpu_torch.ops import track_chain as tc

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 must be off for the float32 correlations")
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    if args.e2e_seeds:
        _build.library()
        e2e_seeds(dev, [int(v) for v in args.e2e_seeds.split(",")],
                  [tuple(v.split(":")) for v in args.e2e_cpu.split(",")
                   if v], args.out)
        return

    # ---- 1. card + kernel build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    ptxas = build_report()
    build_s = time.perf_counter() - t0
    log(f"[1] card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | kernel build {build_s:.2f} s (one nvcc per "
        f"library, in parallel: "
        + ", ".join(f"{n} {r['seconds']:.2f} s"
                    for n, r in _build.BUILD_LOG.items())
        + f"; {' '.join(_build.ARCH_FLAGS)})")
    for name, r in ptxas.items():
        log(f"    ptxas {name}: {r['registers']} registers, "
            f"{r['stack']} B stack frame, {r['spill_stores']} B spill "
            f"stores, {r['spill_loads']} B spill loads")

    # ---- 2. kernels vs plain ----
    t0 = time.perf_counter()
    k_rep = phase_kernels(dev, cc, tc)
    cr, ch = k_rep["chunk_corr"], k_rep["track_chain"]
    log(f"[2] chunk_corr vs plain: max |diff| {cr['max_abs_err']:.3e} "
        f"(random {cr['err_random']:.3e} of max|z| {cr['scale_random']:.3e}, "
        f"mid-track {cr['err_track']:.3e} of {cr['scale_track']:.3e}), "
        f"kernel {cr['ms']:.5f} ms/launch device ({cr['ms_host']:.5f} from "
        f"the host), plain {cr['plain_ms']:.3f} ms, torch.bmm pair "
        f"{cr['library_ms']:.5f} ms, {_corr_bounds(cr)}; "
        f"{k_rep['gps_split']}")
    log(f"    track_chain vs plain: max |diff| {ch['max_abs_err']:.3e} "
        f"(random {ch['err_random']:.3e}, mid-track {ch['err_track']:.3e}), "
        f"int rows exact, kernel {ch['ms']:.5f} ms/launch device "
        f"({ch['ms_host']:.5f} from the host), plain {ch['plain_ms']:.3f} "
        f"ms, bound {ch['bound_ms']:.2e} ms ({ch['bound_by']})")
    log(f"    track_capture ({ch['capture_chunks']} chunks, one call) vs the "
        f"plain chunk loop on the CPU: max |diff| {ch['err_capture']:.3e}, "
        f"int rows exact, {ch['capture_valid_epochs']} valid epochs")
    for r in k_rep["other_rates"] + [k_rep["e1"], k_rep["e1_tiled"]]:
        log(f"    at {r['fs'] / 1e6:g} Msps (K={r['K']}, NW={r['NW']}, "
            f"LW={r['LW']}, {r['split']}, "
            f"{r['samples_per_chip']:.4f} samples/chip): chunk_corr max "
            f"|diff| {r['corr_err']:.3e} of {r['corr_scale']:.3e}, "
            f"track_chain {r['chain_err']:.3e}, capture "
            f"{r['capture_err']:.3e}, int rows exact")
    e1c, e1h = k_rep["e1"]["corr"], k_rep["e1"]["chain"]
    log(f"    Galileo E1 shape (K=5, E=16, C=8, NW={e1c['NW']}): chunk_corr "
        f"{e1c['ms']:.5f} ms/launch device, plain {e1c['plain_ms']:.3f} ms, "
        f"torch.bmm pair {e1c['library_ms']:.5f} ms, {_corr_bounds(e1c)}; "
        f"{k_rep['e1']['split']}; track_chain "
        f"{e1h['ms']:.5f} ms/launch device, plain {e1h['plain_ms']:.3f} ms, "
        f"bound {e1h['bound_ms']:.2e} ms ({e1h['bound_by']})")
    for sig, r in k_rep["sec"].items():
        sc, sh = r["corr"], r["chain"]
        log(f"    {sig} shape (K=3, E=16, C={r['C']}, "
            f"{r['fs'] / 1e6:g} Msps, sec_len={r['sec_len']}, "
            f"sec_idx {r['sec_idx']}, NW={r['NW']}, LW={r['LW']}, "
            f"{r['samples_per_chip']:.4f} samples/chip): chunk_corr max "
            f"|diff| {r['corr_err']:.3e} of {r['corr_scale']:.3e}, "
            f"{sc['ms']:.5f} ms/launch device, plain {sc['plain_ms']:.3f} ms, "
            f"torch.bmm pair {sc['library_ms']:.5f} ms, {_corr_bounds(sc)}; "
            f"{r['split']}; track_chain "
            f"{r['chain_err']:.3e}, {sh['ms']:.5f} ms/launch device, plain "
            f"{sh['plain_ms']:.3f} ms, bound {sh['bound_ms']:.2e} ms "
            f"({sh['bound_by']}); capture {r['capture_err']:.3e}, int rows "
            f"exact")
    for sig, r in (("GLONASS", k_rep["glo"]), ("L2C", k_rep["l2c"])):
        sc, sh = r["corr"], r["chain"]
        log(f"    {sig} shape (K=3, E=16, C={len(r['offsets_hz'])}, "
            f"{r['fs'] / 1e6:g} Msps, NW={r['NW']}, LW={r['LW']}, "
            f"{r['split']}, FDMA biases "
            f"{[round(v) for v in r['offsets_hz']]} Hz): chunk_corr max "
            f"|diff| {r['corr_err']:.3e} of {r['corr_scale']:.3e}, "
            f"{sc['ms']:.5f} ms/launch device, plain {sc['plain_ms']:.3f} ms, "
            f"torch.bmm pair {sc['library_ms']:.5f} ms, {_corr_bounds(sc)}; "
            f"{r['split']}; track_chain "
            f"{r['chain_err']:.3e}, {sh['ms']:.5f} ms/launch device, plain "
            f"{sh['plain_ms']:.3f} ms, bound {sh['bound_ms']:.2e} ms "
            f"({sh['bound_by']}); capture {r['capture_err']:.3e}, int rows "
            f"exact")
    for r in k_rep["instances"]:
        log(f"    track_chain instance {r['instance']} vs plain on the CPU: "
            f"max |diff| {r['err']:.3e}, int rows exact, "
            f"{r['valid_epochs']} valid epochs")
    dg = k_rep["chain_digests"]
    log(f"    track_chain's 16 instances on the recorded inputs: {dg['same']} "
        f"of {dg['total']} outputs bit for bit as recorded")
    log(f"    | {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kf_rows = phase_kf_kernel(dev, kb)
    for r in kf_rows:
        timed = (f", {r['ms']:.5f} ms/launch of one block device "
                 f"({r['ms_host']:.5f} from the host), plain "
                 f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.2e} ms "
                 f"({r['bound_by']}); a cluster of {r['n_cta']} CTAs of "
                 f"{r['threads']} threads, {r['cpc']} channel(s) each at "
                 f"most, {r['smem']} B of shared memory, prefetch "
                 f"{'on' if r['prefetch'] else 'off'}" if "ms" in r else "")
        log(f"[2b] kf_block vs plain on the CPU, {r['what']} (order "
            f"{r['order']}, NIW {'on' if r['bayes'] else 'off'}, C={r['C']}, "
            f"{r['active']} active, {r['fs'] / 1e6:g} Msps, Nmax="
            f"{r['n_max']}, L={r['code_len']}, {r['blocks']} blocks of "
            f"{r['n_epochs']} epochs): int rows exact, Doppler "
            f"{r['doppler']:.2e}, delta {r['delta']:.2e}, rem code "
            f"{r['rem_code']:.2e}, rem carrier {r['rem_carr']:.2e} rad, "
            f"correlators {r['corr']:.3e} ({r['corr_raw']:.3e} raw) of "
            f"{r['corr_scale']:.3e}, CN0 rel {r['cn0']:.1e}, sigma2 rel "
            f"{r['sigma2']:.1e}, {r['valid_epochs']} valid epochs" + timed)
        if "seg_ms" in r:
            sh, su = r["stage_share"], r["stage_us_per_epoch"]
            log(f"    {r['what']}, the engine's {r['seg_blocks']}-block "
                f"launch ({r['seg_epochs']} epochs, "
                f"{r['seg_valid_epochs']} valid): "
                f"{r['seg_ms']:.4f} ms, {r['seg_us_per_epoch']:.3f} us per "
                f"epoch (CUDA events), bound {r['seg_bound_ms']:.2e} ms; "
                f"stage split (KF_BLOCK_STAGES build in "
                f"{r['stage_build_s']:.2f} s, CTA 0, "
                f"{r['stage_mhz']:.0f} cycles per us): "
                + ", ".join(f"{k} {100 * sh[k]:.1f} % ({su[k]:.3f} us)"
                            for k in sh)
                + f" of an epoch of {r['stage_epoch_us']:.3f} us over "
                f"{r['stage_epochs']} epochs (in order: "
                f"{r['stage_ordered']}; in the correlation the prefetch "
                f"wait {r['prefetch_wait_us']:.3f} us and thread 32's "
                f"samples {r['samples_us']:.3f} us; beside it the update's "
                f"state-only part {r['update_pre_us']:.3f} us; "
                f"{r['prefetch_hits']} of the {r['stage_epochs']} epochs "
                f"read the prefetch buffer); serial floor of one block "
                f"{r['serial_floor_ms']:.4f} ms")
    log(f"    | {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    g_rows, g_inst, mc_rows = phase_gather_kernel(dev, gb, mc)
    for r in g_rows:
        prof = ("lost by the profiler" if r.get("ms_profiler") is None
                else f"the profiler's device time {r['ms_profiler']:.5f}")
        timed = (f"; one 40 ms block ({r['block_epochs']} epochs) "
                 f"{r['ms']:.5f} ms/launch (CUDA events; {prof}), plain "
                 f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.2e} ms "
                 f"({r['bound_by']})" if "ms" in r else "")
        log(f"[2c] gather_block vs plain on the CPU, {r['what']} (K={r['K']}, "
            f"order {r['order']}, sec_len {r['sec_len']}, C={r['C']}, "
            f"{r['active']} active, {r['fs'] / 1e6:g} Msps, Nmax="
            f"{r['n_max']}, L={r['code_len']}, {r['n_epochs']} epochs, FDMA "
            f"biases {r['carr_offsets_hz']} Hz; a cluster of {r['n_cta']} "
            f"CTAs of {r['threads']} threads, {r['cpc']} channel(s) each at "
            f"most, {r['smem']} B of shared memory, prefetch "
            f"{'on' if r['prefetch'] else 'off'}): int rows exact, Doppler "
            f"{r['doppler']:.2e}, delta {r['delta']:.2e}, rem code "
            f"{r['rem_code']:.2e}, rem carrier {r['rem_carr']:.2e} rad, "
            f"correlators {r['corr']:.3e} ({r['corr_raw']:.3e} raw) of "
            f"{r['corr_scale']:.3e}, CN0 rel {r['cn0']:.1e}, "
            f"{r['valid_epochs']} valid epochs" + timed)
        if "seg_ms" in r:
            sp = r["stages"]
            log(f"    {r['what']}, the receiver's 1 s segment launch "
                f"({r['seg_epochs']} epochs, {r['seg_valid_epochs']} valid): "
                f"{r['seg_ms']:.4f} ms, {r['seg_us_per_epoch']:.3f} us per "
                f"epoch (CUDA events), bound {r['seg_bound_ms']:.2e} ms; "
                f"stage split (GATHER_BLOCK_STAGES build, CTA 0, "
                f"{sp['mhz']:.0f} cycles per us): "
                + ", ".join(f"{k} {100 * sp['share'][k]:.1f} % "
                            f"({sp['us'][k]:.3f} us)" for k in sp["us"])
                + f" of an epoch of {sp['epoch_us']:.3f} us over "
                f"{sp['epochs']} epochs (in order: {sp['ordered']}; in the "
                f"correlation the prefetch wait "
                f"{sp['inner_us']['prefetch_wait']:.3f} us and thread 32's "
                f"samples {sp['inner_us']['samples']:.3f} us; the closure's "
                f"state-only part {sp['inner_us']['closure_pre']:.3f} us "
                f"beside it; "
                f"{sp['prefetch_hits']} of the {sp['epochs']} epochs read "
                f"the prefetch buffer); serial floor of one 40 ms block "
                f"{r['serial_floor_ms']:.4f} ms")
    for r in g_inst:
        log(f"    gather_block instance {r['instance']} vs plain on the CPU: "
            f"max |diff| {r['err']:.3e}, int rows exact, "
            f"{r['valid_epochs']} valid epochs")
    mc_ptx = {k: v for k, v in ptxas.items()
              if k.startswith("multicorrelate")}
    for r in mc_rows:
        log(f"[2c] multicorrelate_cuda vs plain on the CPU, {r['what']} "
            f"(K={r['K']}, C={r['C']}, N={r['N']}, n_valid {r['n_valid']}"
            f"{', order ' + str(r['order']) if 'order' in r else ''}; "
            f"clusters of {r['G']} CTAs of {mc.MC_THREADS} threads, "
            f"{r['slice']} samples each): max |diff| {r['max_abs_err']:.3e} "
            f"of {r['scale']:.3e}, by value == by pointer"
            + (", order 3 at a zero rate == order 2"
               if r.get("order3_at_zero_rate_equal") else ""))
        if "ms" in r:
            for shape, t in (("4,094", r), ("2,046", r["tcp_shape"])):
                log(f"    C=1, K=3, {shape} samples, Python numbers by value: "
                    f"kernel {t['kernel'].split('(')[0]} {t['ms']:.5f} ms "
                    f"device (profiler, by name), {t['events_ms']:.5f} ms a "
                    f"call back to back (CUDA events), {t['host_us']:.2f} us "
                    f"of host a call; other kernels {t['other_kernels']}, "
                    f"copies {t['copies']}; the empty kernel of the same "
                    f"geometry {t['empty_ms']:.5f} ms device "
                    f"({t['empty_host_us']:.2f} us of host); plain "
                    f"{t['plain_ms']:.3f} ms; bound {t['bound_ms']:.2e} ms "
                    f"({t['bound_by']})")
            st = r["stages"]
            sp = st["split"]
            log(f"    MC_STAGES build, {st['G']} CTAs ({st['ms']:.5f} ms, "
                f"{sp['mhz']:.0f} cycles per us), cycles per CTA: "
                + ", ".join(f"{k} {v:.0f}" for k, v in sp["cycles"].items())
                + f" (in order: {sp['ordered']}); thread 0 "
                f"{sp['samples_thread0']:.2f} samples at "
                f"{sp['cycles_per_sample']:.0f} cycles each; one CTA for the "
                f"channel, cycles a sample: "
                + ", ".join(f"{k} {v['cycles_per_sample']:.0f}"
                            for k, v in st["probes"].items())
                + f" ({st['probes']['full']['samples_thread0']:.0f} "
                f"samples a thread)")
    log("    ptxas multicorrelate: " + ", ".join(
        f"{k} {v['registers']} registers, {v['spill_stores']}/"
        f"{v['spill_loads']} B spilled" for k, v in mc_ptx.items()))
    log(f"    | {time.perf_counter() - t0:.1f} s")
    if not cr["ms"] <= cr["library_ms"]:
        raise AssertionError(f"chunk_corr {cr['ms']:.5f} ms is slower than "
                             f"the torch.bmm pair {cr['library_ms']:.5f} ms")
    t0 = time.perf_counter()
    sym_rows = phase_symbol_kernel(dev)
    for r in sym_rows:
        timed = (f"; kernel {r['ms']:.5f} ms/launch device (profiler, by "
                 f"name), {r['events_ms']:.5f} ms a call back to back (CUDA "
                 f"events), plain {r['plain_ms']:.3f} ms (CUDA events), "
                 f"bound {r['bound_ms']:.2e} ms ({r['bound_by']})"
                 if "ms" in r else "")
        log(f"[2d] symbol_slots vs symbol_slots_plain on the card, "
            f"{r['what']} (cap {r['cap']}, C={r['C']}, N={r['N']}, "
            f"S={r['S']}, K={r['K']}, {r['drops']} channels dropping): "
            f"bit for bit through both libraries, one launch a call"
            + timed)
    log(f"    | {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    xf_rows = phase_xlate_kernel(dev)
    for r in xf_rows:
        log(f"[2e] xlate_fir vs xlate_fir_plain on the card, {r['what']} "
            f"({r['fmt']}, {r['outputs']} outputs, {r['taps']} taps, D="
            f"{r['decim']}): max |diff| {r['err']:.3e} of RMS {r['rms']:.3e} "
            f"({r['bits_equal']:.4f} of the outputs bit for bit), the seam "
            f"of two segments bit for bit one launch's, one launch a "
            f"segment; kernel {r['ms']:.5f} ms/launch device (profiler, by "
            f"name), {r['events_ms']:.5f} ms a call back to back (CUDA "
            f"events), plain {r['plain_ms']:.3f} ms (CUDA events), bound "
            f"{r['bound_ms']:.2e} ms ({r['bound_by']})")
    log(f"    | {time.perf_counter() - t0:.1f} s")

    # ---- the generator on the card, held to numpy on every capture ----
    t0 = time.perf_counter()
    twin = check_card_generator(dev)
    log(f"    generator on the card vs numpy, noiseless {twin['s'] * 1e3:g} ms "
        f"in {twin['block_s'] * 1e3:g} ms blocks: max |diff| "
        + ", ".join(f"{k} {v:.2e}" for k, v in twin["err"].items())
        + f" of amplitude 1 | {time.perf_counter() - t0:.1f} s")

    # ---- 3. acquisition ----
    sats, x_eng, gen_s = engine_capture(dev)
    t0 = time.perf_counter()
    acq = phase_acquisition(dev, sats, x_eng)
    gps_head = x_eng[: int(FS * 0.1)].copy()      # phase 9's GPS samples
    log(f"[3] acquisition: {acq['detected']}/12 at the true Doppler and "
        f"delay, {acq['ffts_per_s']:.0f} FFTs/s "
        f"({acq['ms_per_call']:.2f} ms/call, F={acq['fft_size']}); against "
        f"the CPU run: same detections and Doppler bins, max delay diff "
        f"{acq['cpu_max_delay_diff']:.3f} samples, max stat rel diff "
        f"{acq['cpu_max_stat_rel']:.2e} | "
        f"{time.perf_counter() - t0:.1f} s (capture made in {gen_s:.1f} s)")

    # ---- 4. engine ----
    t0 = time.perf_counter()
    eng = phase_engine(dev, cc, tc, sats, x_eng)
    log(f"[4] engine: 12 ch x {eng['signal_s']:.1f} s, RTF "
        f"{eng['rtf']:.2f} ({eng['wall_s']:.3f} s), valid "
        f"{eng['n_valid']}/{eng['expected']:.0f} epochs, launches "
        f"chunk_corr {eng['launches_chunk_corr']} track_chain "
        f"{eng['launches_track_chain']} == chunks {eng['chunks']} | "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 5. receiver end to end (the main path) ----
    t0 = time.perf_counter()
    scen, x_e2e, gen_s = e2e_capture(dev)
    e2e = phase_e2e(dev, cc, tc, scen, x_e2e)
    log(f"[5] receiver e2e: 12 sats x {E2E_S:g} s, RTF {e2e['rtf']:.2f} "
        f"({e2e['wall_s']:.2f} s), fixes {e2e['fixes']}, median 3D error "
        f"{e2e['median_3d_m']:.2f} m, launches chunk_corr "
        f"{e2e['launches_chunk_corr']} track_chain "
        f"{e2e['launches_track_chain']} == chunks {e2e['chunks']} | "
        f"{time.perf_counter() - t0:.1f} s (capture made in {gen_s:.1f} s)")

    # ---- 23. the same receiver on the gather correlator ----
    t0 = time.perf_counter()
    g23 = phase_gather_e2e(dev, gb, scen, x_e2e)
    log(f"[23] receiver e2e, correlator='gather': 12 sats x {E2E_S:g} s, RTF "
        f"{g23['rtf']:.2f} ({g23['wall_s']:.2f} s; phase 5's chunked "
        f"{e2e['rtf']:.2f}), fixes {g23['fixes']} ({e2e['fixes']}), median "
        f"3D error {g23['median_3d_m']:.2f} m ({e2e['median_3d_m']:.2f} m), "
        f"gather_block launches {g23['launches_gather_block']} == segments "
        f"{g23['segments']}, {g23['epochs']} epochs walked, "
        f"{g23['device_us_per_epoch']:.3f} us of gather_block device time "
        f"per epoch (CUDA events) | {time.perf_counter() - t0:.1f} s")

    # ---- 6-8. the conf-file CLI on files written from phase 5's capture ----
    t0 = time.perf_counter()
    files = write_cli_files(x_e2e)
    log(f"    CLI captures written ({', '.join(p.name for p in files)}) | "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli6 = phase_cli_passthrough(cc, tc, scen, files[0])
    log(f"[6] CLI, ishort file, Pass_Through: {cli6['summary']} | "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli7 = phase_cli_if(dev, cc, tc, scen, files[1])
    log(f"[7] CLI, IF {IF_HZ / 1e3:g} kHz, Freq_Xlating_Fir_Filter to "
        f"{FS_IF / 1e6:g} Msps: {cli7['summary']}; conditioner on the card "
        f"vs the CPU over {cli7['cond_check_s']:g} s: max |diff| "
        f"{cli7['cond_err']:.3e} of max {cli7['cond_scale']:.3e}, "
        f"{cli7['condition_s']:.3f} s to condition the {E2E_S:g} s | "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli8 = phase_cli_kf(dev, cc, tc, kb, scen, files[0])
    kfp = cli8["profile"]
    log(f"[8] CLI, GPS_L1_CA_KF_Tracking: {cli8['summary']}; "
        f"{cli8['kf_epochs']} KF epochs in {cli8['kf_blocks']} blocks, "
        f"kf_block launches {cli8['launches_kf_block']} == engine calls "
        f"{cli8['kf_calls']}, {cli8['kf_device_us_per_epoch']:.2f} us of "
        f"kf_block device time per epoch over the run (CUDA events), "
        f"{cli8['ms_per_epoch']:.4f} ms of wall per epoch; one segment "
        f"({kfp['segment_blocks']} blocks, "
        f"{kfp['epochs']} epochs, 12 ch): {kfp['launches_per_epoch']:.4f} "
        f"kernel launches per epoch ({kfp['kernels_per_call']} in the "
        f"engine call, counted in a CUDA graph of it), "
        f"{kfp['device_us_per_epoch']:.2f} us of device time per epoch "
        f"(kf_block {kfp['kf_device_us_per_epoch']:.2f} us), "
        f"{kfp['wall_ms_per_epoch']:.4f} ms of wall; one block alone "
        f"{kfp['block_launches_per_epoch']:.3f} launches per epoch | "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli26 = phase_cli_gather(gb, scen, files[0])
    log(f"[26] CLI, conf/gps_l1_ishort.conf + Tracking_1C.correlator=gather "
        f"on phase 6's file ({FS / 1e6:g} -> {FS / 2e6:g} Msps, 12 "
        f"channels): {cli26['summary']} | {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli8k = phase_cli_kalman(dev, kb)
    log(f"[8] CLI, conf/gps_l1_kalman.conf as written on the e2e scenario at "
        f"{FS_KALMAN / 1e6:g} Msps: {cli8k['summary']}; {cli8k['kf_epochs']} "
        f"KF epochs, kf_block launches {cli8k['launches_kf_block']}, "
        f"{cli8k['kf_device_us_per_epoch']:.2f} us of kf_block device time "
        f"per epoch | "
        f"{time.perf_counter() - t0:.1f} s (capture made on the card in "
        f"{cli8k['gen_s']:.2f} s)")

    # ---- 9-11. acquisition strategies, Galileo E1 receiver and CLI ----
    t0 = time.perf_counter()
    scen_e1, x_e1, gen_s = e1_capture(dev)
    log(f"    Galileo E1 capture made on the card ({len(E1_PRNS)} sats x "
        f"{E1_S:g} s at {FS_E1 / 1e6:g} Msps) | {gen_s:.2f} s")
    t0 = time.perf_counter()
    acqv = phase_acq_variants(dev, x_e1[: int(FS_E1 * 0.3)], gps_head)
    log("[9] acquisition strategies, card vs CPU (same detections and "
        "Doppler bins, delays within 1 sample, statistics within 1e-4):")
    for r in acqv:
        log(f"    {r['what']}: {r['detected']} detections, max delay diff "
            f"{r['max_delay_diff']:.3f} samples, max Doppler diff "
            f"{r['max_doppler_diff']:.3f} Hz, max stat rel diff "
            f"{r['max_stat_rel']:.2e}, {r['ms_per_call']:.2f} ms/call")
    log(f"    | {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e1 = phase_e1(dev, cc, tc, scen_e1, x_e1)
    log(f"[10] Galileo E1 receiver e2e: {len(E1_PRNS)} sats x {E1_S:g} s, "
        f"RTF {e1['rtf']:.2f} ({e1['wall_s']:.2f} s), ephemerides "
        f"{e1['ephemerides']} (max |sqrt_a err| {e1['max_sqrt_a_err']:.2e}), "
        f"fixes {e1['fixes']}, median 3D error {e1['median_3d_m']:.2f} m, "
        f"launches chunk_corr {e1['launches_chunk_corr']} track_chain "
        f"{e1['launches_track_chain']} == chunks {e1['chunks']} | "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    CACHE.mkdir(exist_ok=True)
    e1_file = CACHE / f"e1_{FS_E1:.0f}_{E1_S:.0f}.gr_complex"
    x_e1.tofile(e1_file)
    del x_e1
    cli11 = phase_cli_galileo(cc, tc, scen_e1, e1_file)
    for name, r in cli11.items():
        log(f"[11] CLI, {name}: {r['summary']}")
    log(f"    | {time.perf_counter() - t0:.1f} s")

    # ---- 12-14. GPS L5 and Galileo E5a receivers and CLI ----
    sec_runs, sec_caps, cli14 = {}, {}, {}
    for sig in ("L5", "5X"):
        scen_s, x_s, gen_s = sec_capture(dev, sig)
        sec_caps[sig] = scen_s, x_s
        fs, dur, prns = _SEC_CELLS[sig]
        log(f"    {sig} capture made on the card ({len(prns)} sats x {dur:g} "
            f"s at {fs / 1e6:g} Msps) | {gen_s:.2f} s")
        t0 = time.perf_counter()
        r = phase_sec(dev, cc, tc, scen_s, x_s, sig)
        sec_runs[sig] = r
        log(f"[{12 if sig == 'L5' else 13}] {sig} receiver e2e "
            f"({r['strategy']}): {len(prns)} sats x {dur:g} s, RTF "
            f"{r['rtf']:.2f} ({r['wall_s']:.2f} s), ephemerides "
            f"{r['ephemerides']} (max |sqrt_a err| {r['max_sqrt_a_err']:.2e}"
            f"{r['pages']}), fixes {r['fixes']}, median 3D error "
            f"{r['median_3d_m']:.2f} m, launches chunk_corr "
            f"{r['launches_chunk_corr']} track_chain "
            f"{r['launches_track_chain']} == chunks {r['chunks']}, chain "
            f"instances {r['instances']}, {r['sec_chunks']} chunks with the "
            f"secondary wipe on | {time.perf_counter() - t0:.1f} s")
    for sig in ("L5", "5X"):
        t0 = time.perf_counter()
        cli14.update(phase_cli_sec(cc, tc, *sec_caps.pop(sig), sig))
        log(f"    | {time.perf_counter() - t0:.1f} s")

    # ---- 15. GLONASS L1 receiver with FDMA ----
    scen_glo = _cells()["1G"][0]
    x_glo, gen_s = card_capture(dev, ["1G"], 106)
    t0 = time.perf_counter()
    glo = phase_glonass(dev, cc, tc, scen_glo, x_glo)
    del x_glo
    ls = glo["long_segments"]
    log(f"[15] GLONASS L1 receiver e2e (FDMA k {sorted(GLO_KS.values())}): "
        f"{len(GLO_KS)} slots x {GLO_S:g} s at {FS_GLO / 1e6:g} Msps, RTF "
        f"{glo['rtf']:.2f} ({glo['wall_s']:.2f} s), {glo['tracked']} slots "
        f"tracked > 10,000 epochs, GNAV ephemerides {glo['ephemerides']} "
        f"(equal to the broadcast truth), fixes {glo['fixes']}, median 3D "
        f"error {glo['median_3d_m']:.2f} m, launches chunk_corr "
        f"{glo['launches_chunk_corr']} track_chain "
        f"{glo['launches_track_chain']} == chunks {glo['chunks']} on "
        f"<3,3,false,false>, {glo['offset_chunks']} chunks with a non-zero "
        f"FDMA bias, {glo['segments']} segments; with 5 s segments "
        f"{ls['segments']} segments, RTF {ls['rtf']:.2f}, {ls['fixes']} "
        f"fixes | {time.perf_counter() - t0:.1f} s (capture made on the "
        f"card in {gen_s:.2f} s)")

    # ---- 16. GPS L1 + Galileo E1B on one stream, joint PVT ----
    x_mix, gen_s = card_capture(dev, ["mixed 1C", "mixed 1B"], 107)
    t0 = time.perf_counter()
    mix = phase_mixed(dev, cc, tc, x_mix)
    log(f"[16] MultiReceiver GPS L1 C/A + Galileo E1B on one stream: "
        f"{len(MIX_GPS)} + {len(MIX_GAL)} sats x {MIX_S:g} s at "
        f"{FS_MIX / 1e6:g} Msps, RTF {mix['rtf']:.2f} ({mix['wall_s']:.2f} "
        f"s), ephemerides GPS {mix['ephemerides_gps']} E1 "
        f"{mix['ephemerides_e1']}, joint fixes {mix['fixes']} (every one "
        f"on G and E; none from the Galileo group alone), median 3D error "
        f"{mix['median_3d_m']:.2f} m, per group launches == chunks "
        + ", ".join(f"{g['signal']} {g['chunks']} on "
                    f"{list(g['instances'])}" for g in mix["groups"])
        + f" | {time.perf_counter() - t0:.1f} s (capture made on the card "
        f"in {gen_s:.2f} s)")

    # ---- 17. GPS L1 + L2C on two streams, joint PVT ----
    x1, g1 = card_capture(dev, ["dual 1C"], 108)
    x2, g2 = card_capture(dev, ["dual 2S"], 109)
    t0 = time.perf_counter()
    dual = phase_dual(dev, cc, tc, x1, x2)
    dual["l2c_segments"] = _l2c_segments(dev, cc, tc, x2)
    del x1, x2
    seg = dual["l2c_segments"]
    log(f"[17] MultiReceiver GPS L1 + L2C on two streams: "
        f"{len(DUAL_PRNS)} sats x {DUAL_S:g} s at {FS_DUAL / 1e6:g} Msps, "
        f"RTF {dual['rtf']:.2f} ({dual['wall_s']:.2f} s), CNAV ephemerides "
        f"{dual['cnav_ephemerides']}, joint fixes {dual['fixes']}, median 3D "
        f"error {dual['median_3d_m']:.2f} m (converged half "
        f"{dual['median_3d_converged_half_m']:.2f} m), per group launches "
        f"== chunks " + ", ".join(f"{g['signal']} {g['chunks']}"
                                  for g in dual["groups"])
        + f"; the L2C group alone: {seg[25]['segments']} segments (RTF "
        f"{seg[25]['rtf']:.2f}) at 1 s, {seg[125]['segments']} (RTF "
        f"{seg[125]['rtf']:.2f}) at 5 s | {time.perf_counter() - t0:.1f} s "
        f"(captures made on the card in {g1 + g2:.2f} s)")

    # ---- 18. the CLI on the four confs this slice ports ----
    t0 = time.perf_counter()
    cli18 = phase_cli_multi(dev, cc, tc, x_mix)
    del x_mix
    log(f"    | {time.perf_counter() - t0:.1f} s")

    # ---- 19-21. BeiDou B1I and B3I receivers, bds_b1i_ibyte.conf ----
    bds = {}
    for sig, seed in (("B1", 110), ("B3", 111)):
        fs, dur, prns = _BDS_CELLS[sig]
        x_b, gen_s = card_capture(dev, [sig], seed)
        t0 = time.perf_counter()
        r = phase_bds(dev, cc, tc, _cells()[sig][0], x_b, sig)
        bds[sig] = r
        log(f"[{19 if sig == 'B1' else 21}] BeiDou {sig}I receiver e2e: "
            f"{len(prns)} D1 sats x {dur:g} s at {fs / 1e6:g} Msps, RTF "
            f"{r['rtf']:.2f} ({r['wall_s']:.2f} s), ephemerides "
            f"{r['ephemerides']} (system {r['systems']}, max |sqrt_a err| "
            f"{r['max_sqrt_a_err']:.2e}), fixes {r['fixes']}, median 3D "
            f"error {r['median_3d_m']:.2f} m, mean-bias norm "
            f"{r['bias_norm_m']:.2f} m, launches chunk_corr "
            f"{r['launches_chunk_corr']} track_chain "
            f"{r['launches_track_chain']} == chunks {r['chunks']} on "
            f"{list(r['instances'])}, {r['sec_chunks']} chunks with the "
            f"NH20 wipe on, {r['segments']} segments | "
            f"{time.perf_counter() - t0:.1f} s (capture made on the card in "
            f"{gen_s:.2f} s)")
        if sig == "B1":
            t0 = time.perf_counter()
            cli20 = phase_cli_bds(cc, tc, _cells()[sig][0], x_b)
            log(f"    | {time.perf_counter() - t0:.1f} s")
        del x_b

    # ---- 22. the Galileo E1B receiver with the KF tracker ----
    scen_e1, x_e1, gen_s = e1_capture(dev)
    t0 = time.perf_counter()
    e1kf = phase_e1_kf(dev, kb, scen_e1, x_e1)
    del x_e1
    log(f"[22] Galileo E1 KF receiver e2e (virtual basis): {len(E1_PRNS)} "
        f"sats x {E1_S:g} s, RTF {e1kf['rtf']:.2f} ({e1kf['wall_s']:.2f} s), "
        f"{e1kf['held']} channels held, Doppler errors "
        f"{[round(v, 2) for v in e1kf['doppler_err_hz'].values()]} Hz, "
        f"ephemerides {e1kf['ephemerides']} (max |sqrt_a err| "
        f"{e1kf['max_sqrt_a_err']:.2e}), fixes {e1kf['fixes']}, median 3D "
        f"error {e1kf['median_3d_m']:.2f} m, kf_block launches "
        f"{e1kf['launches_kf_block']} == engine calls {e1kf['kf_calls']} "
        f"({e1kf['launches_per_block']:.3f} per block, {e1kf['kf_epochs']} "
        f"epochs, {e1kf['kf_device_us_per_epoch']:.2f} us of kf_block device "
        f"time per epoch) | {time.perf_counter() - t0:.1f} s (capture made on "
        f"the card in {gen_s:.2f} s)")

    # ---- 24-25. the system tests' 5-satellite scenarios, gather path ----
    sys_runs = {}
    for n, name in ((24, "sys 1B"), (25, "sys B1")):
        t0 = time.perf_counter()
        r = sys_runs[name] = phase_gather_system(dev, gb, name)
        _, _, sats, _, fs, dur = _cells()[name]
        log(f"[{n}] {name[4:]} system scenario, correlator='gather': "
            f"{len(sats)} sats x {dur:g} s at {fs / 1e6:g} Msps, RTF "
            f"{r['rtf']:.2f} ({r['wall_s']:.2f} s), ephemerides "
            f"{r['ephemerides']} (max |sqrt_a err| {r['max_sqrt_a_err']:.2e}"
            f"), fixes {r['fixes']}, median 3D error {r['median_3d_m']:.2f} "
            f"m, mean-bias norm {r['bias_norm_m']:.2f} m, gather_block "
            f"launches {r['launches_gather_block']} == segments "
            f"{r['segments']}, {r['device_us_per_epoch']:.3f} us of device "
            f"time per epoch | {time.perf_counter() - t0:.1f} s (capture "
            f"made on the card in {r['gen_s']:.2f} s)")

    # ---- 27. the TCP connector on the card ----
    t0 = time.perf_counter()
    tcp = phase_tcp(dev, mc)
    sp = tcp["split"]
    log(f"[27] TCP connector, correlation on the card: {tcp['epochs']} "
        f"epochs, multicorrelate launches {tcp['launches_multicorrelate']} "
        f"== epochs, tail Doppler error {tcp['tail_doppler_err_hz']:+.3f} "
        f"Hz, tail/head prompt {tcp['prompt_tail_over_head']:.3f}, "
        f"{tcp['ms_per_epoch']:.3f} ms of wall per epoch (TCP round trip "
        f"included); an epoch's wall, mean / p90 ms: "
        + ", ".join(f"{k} {v['mean_ms']:.4f} / {v['p90_ms']:.4f}"
                    for k, v in sp.items())
        + f"; with the controller in a process of its own (as deployed) "
        f"{tcp['external_ms_per_epoch']:.3f} ms an epoch, the same rows: "
        + ", ".join(f"{k} {v['mean_ms']:.4f} / {v['p90_ms']:.4f}"
                    for k, v in tcp["external_split"].items())
        + f"; the first {tcp['cpu_epochs']} rows as on the CPU (the same "
        f"starts, Doppler within {tcp['cpu_doppler_diff_hz']:.2e} Hz, "
        f"prompts within {tcp['cpu_prompt_diff']:.2e} of "
        f"{tcp['cpu_prompt_scale']:.3e}); {tcp['profile_epochs']} epochs "
        f"profiled: kernels {tcp['profile_kernels']}, copies "
        f"{tcp['profile_copies']} | {time.perf_counter() - t0:.1f} s")
    # the launch counter holds one launch an epoch; the profiler loses some
    # of its events (PERF.md section 7), so the trace is read only for
    # what must not be there
    h2d = {k: v for k, v in tcp["profile_copies"].items() if "HtoD" in k}
    extra = {k: v for k, v in tcp["profile_kernels"].items()
             if "multicorrelate_kernel" not in k}
    if h2d or extra or not any("multicorrelate_kernel" in k
                               for k in tcp["profile_kernels"]):
        raise AssertionError(f"TCP connector: the profiled epochs copied "
                             f"{h2d} to the card and launched {extra} beside "
                             f"the multicorrelator "
                             f"({tcp['profile_kernels']})")

    # ---- 28. the streaming receiver on raw blocks ----
    t0 = time.perf_counter()
    s28 = phase_stream(dev, cc, tc, gb, scen, files[0], e2e)
    for name, r in s28.items():
        launches = (f"gather_block launches {r['launches_gather_block']} == "
                    f"segments {r['segments']}, "
                    f"{r['device_us_per_epoch']:.3f} us of gather_block "
                    f"device time per epoch" if name == "gather" else
                    f"launches chunk_corr {r['launches_chunk_corr']} "
                    f"track_chain {r['launches_track_chain']} == chunks "
                    f"{r['chunks']}")
        unpack = (f", unpack {r['unpack_ms']:.4f} ms a segment (CUDA events"
                  + ("; lost by the profiler)" if r["unpack_ms_profiler"]
                     is None else f"; {r['unpack_ms_profiler']:.4f} ms of "
                     f"device time from the profiler)")
                  if "unpack_ms" in r else "")
        monitor = (f", PVT datagrams {r['datagrams']} == fixes; process()'s "
                   f"fixes over the stream's span {r['same_epochs']} of "
                   f"{r['process_fixes_in_span']} at the same epochs, "
                   f"{r['same_epoch_median_diff_m']:.3f} m apart (median)"
                   if "datagrams" in r else "")
        log(f"[28] process_stream, raw {'ishort' if name == 'gather' else name}"
            f"{', correlator=gather' if name == 'gather' else ''} in "
            f"{STREAM_BLOCK_S:g} s blocks, {STREAM_SEGMENT_S:g} s segments: "
            f"{r['signal_s']:.2f} s of signal, RTF {r['rtf']:.2f} "
            f"({r['wall_s']:.2f} s; process() {e2e['rtf']:.2f}), fixes "
            f"{r['fixes']} from {r['first_fix_s']:.1f} s (process() "
            f"{e2e['fixes']}), median 3D error "
            f"{r['median_3d_m']:.2f} m{monitor}, {launches}, host to device "
            f"{r['h2d_bytes_per_signal_s'] / 1e6:.3f} MB per signal second"
            f"{unpack}; {r['segments']} segments, {r['segment_device_ms']:.3f}"
            f" ms on the device and {r['harvest_ms']:.3f} ms of harvest wall "
            f"a segment, the next segment on the device "
            f"{100 * r['overlap_share']:.1f} % of the harvest wall")
    log(f"    | {time.perf_counter() - t0:.1f} s")

    # ---- 29. rtl_tcp over loopback into process_stream ----
    t0 = time.perf_counter()
    r29 = phase_rtl_tcp(dev, cc, tc, scen, files[0])
    log(f"[29] rtl_tcp loopback (uint8 I/Q, {RTL_SCALE:g} counts a unit) into "
        f"process_stream: {r29['signal_s']:.2f} s of signal, RTF "
        f"{r29['rtf']:.2f} ({r29['wall_s']:.2f} s), fixes {r29['fixes']} "
        f"from {r29['first_fix_s']:.1f} s ([28] {s28['ishort']['fixes']}), "
        f"median 3D error "
        f"{r29['median_3d_m']:.2f} m, commands {r29['commands']}, launches "
        f"chunk_corr {r29['launches_chunk_corr']} track_chain "
        f"{r29['launches_track_chain']} == chunks {r29['chunks']} | "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 30. checkpoint on the card, resume, the rest ----
    t0 = time.perf_counter()
    c30 = phase_checkpoint(dev, cc, tc, scen, x_e2e, e2e)
    log(f"[30] checkpoint at {c30['split_s']:.2f} s ({c30['ckpt_bytes']} B, "
        f"written in {c30['ckpt_s']:.3f} s, resumed on the card in "
        f"{c30['resume_s']:.3f} s, and on the CPU with the same tracking "
        f"state): {c30['fixes']} fixes after the resume, the last 10's mean "
        f"{c30['last10_diff_m']:.3f} m from phase 5's, launches chunk_corr "
        f"{c30['launches_chunk_corr']} track_chain "
        f"{c30['launches_track_chain']} == chunks {c30['chunks']} | "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 31. A-GNSS: SUPL, --assist and the hot start ----
    t0 = time.perf_counter()
    a31 = phase_agnss(dev, cc, tc)
    g31 = a31["grids"]
    for name, how in (("supl", "--supl"), ("cold", "cold"),
                      ("assist", "--assist")):
        r = a31[name]
        log(f"[31] CLI, conf/gps_l1_supl_assisted.conf at "
            f"{FS_AGNSS / 1e6:g} Msps, {AGNSS_CHANNELS} channels, {how}: "
            f"{r['summary']}, predicted visible "
            f"{'-' if r['visible'] is None else r['visible']}, "
            f"{len(r['acq'])} satellites assigned, first fix "
            f"{r['first_fix_s']:.2f} s"
            + (f", acquisition Doppler within {r['max_doppler_off_hz']:g} Hz "
               f"of the cold run's" if name != "cold" else ""))
    log(f"[31] acquisition grids on the same samples, ms a call over "
        f"{AGNSS_ACQ_CALLS} calls (CUDA events, uploads and readback "
        f"included; the kernels' device time from the profiler): "
        + "; ".join(f"{k} {g['bins']} Doppler bins x {g['prns']} PRNs, "
                    f"F={g['fft_size']}, {g['ms_per_call']:.4f} ms, device "
                    f"{g['device_ms_per_call']:.4f} ms"
                    for k, g in g31.items()))
    h31 = a31["hot"]
    log(f"[31] hot start from the cold run's brdc.rnx "
        f"({h31['ephemerides']} ephemerides, Receiver.load_ephemerides): "
        f"fixes {h31['fixes']}, median 3D error {h31['median_3d_m']:.2f} m, "
        f"first fix {h31['first_fix_s']:.2f} s (cold "
        f"{a31['cold']['first_fix_s']:.2f} s), RTF {h31['rtf']:.2f}, "
        f"launches chunk_corr {h31['launches_chunk_corr']} track_chain "
        f"{h31['launches_track_chain']} == chunks {h31['chunks']} | "
        f"{time.perf_counter() - t0:.1f} s (capture made in "
        f"{a31['gen_s']:.2f} s, written in {a31['write_s']:.1f} s)")

    # ---- 32. PPP on the card's observables ----
    t0 = time.perf_counter()
    p32 = phase_ppp(cc, tc, scen, files[0])
    for name, r in p32.items():
        log(f"[32] CLI, conf/gps_l1_ishort.conf, PPP_Static, {name} "
            f"orbits, on phase 6's file to {PPP_RTK_S:g} s: {r['summary']}; "
            f"solve_ppp_batch "
            f"{r['ppp_wall_s']:.3f} s, {r['epochs']} epochs, {r['arcs']} "
            f"arcs, sigma0 {r['sigma0_m']:.3f} m, ztd_wet "
            f"{r['ztd_wet_m']:.3f} m, 3D error {r['err_3d_m']:.3f} m")
    log(f"    | {time.perf_counter() - t0:.1f} s")

    # ---- 33. RTK through --base_obs ----
    t0 = time.perf_counter()
    r33 = phase_rtk(dev, cc, tc, scen, files[0])
    log(f"[33] base CLI, {r33['truth_m']:.1f} m from the rover, 12 sats x "
        f"{E2E_S:g} s at {FS / 1e6:g} Msps: {r33['base']['summary']}; "
        f"{r33['base_epochs']} MSM epochs, its MT1005 position "
        f"{r33['base_ecef_err_m']:.2f} m from the truth")
    for mode in ("DGNSS", "Kinematic"):
        r = r33[mode]
        log(f"[33] rover CLI, PVT.positioning_mode={mode}, --base_obs, "
            f"phase 6's file to {PPP_RTK_S:g} s: "
            f"{r['summary']}; {'fixed' if r['fixed'] else 'float'}, ratio "
            f"{r['ratio']:.2f}, {r['epochs']} epochs, baseline "
            f"{r['baseline_m']:.3f} m ({r['baseline_err_m']:+.3f} m against "
            f"the truth), rover {r['rover_err_3d_m']:.3f} m from its truth, "
            f"{'solve_baseline' if mode == 'DGNSS' else 'solve_baseline_ekf'}"
            f" {r['rtk_wall_s']:.3f} s")
    log(f"    | {time.perf_counter() - t0:.1f} s (base capture made in "
        f"{r33['gen_s']:.2f} s)")

    # ---- 34. the channel-sharded receiver over a mesh ----
    t0 = time.perf_counter()
    s34 = phase_sharded(dev, cc, tc, gb, x_eng, scen, x_e2e, files[1])
    del x_eng, x_e2e
    log(f"[34] mesh: {s34['mesh']}")
    for r in s34["runs"]:
        log(f"[34] {r['what']}, {r['shards']} shards: equal to the "
            f"unsharded run (every output row, final state), "
            f"{r['valid']} valid epochs, launches per shard "
            f"{r['launches_per_shard']} == {r['unit']} {r['units_per_shard']}"
            f", {r['wall_s']:.3f} s (unsharded {r['unsharded_wall_s']:.3f} s)")
    a34 = s34["acquisition"]
    log(f"[34] acquisition, {a34['prns']} PRNs x {a34['bins']} Doppler bins, "
        f"F={a34['fft_size']}, {a34['dwells']} dwells, PRN rows over "
        + ", ".join(f"{n} shards {ms:.3f} ms" for n, ms in a34["ms"].items())
        + f" (unsharded {a34['unsharded_ms']:.3f} ms, host wall a call): "
        f"equal to the unsharded AcqResult, {a34['positive']} positive")
    c34 = s34["conditioner"]
    log(f"[34] conditioner (phase 7's: {c34['taps']} taps, IF "
        f"{IF_HZ / 1e3:g} kHz, decimation 2) over {c34['seconds']:g} s in "
        + ", ".join(f"{n} time blocks {ms:.2f} ms" for n, ms in
                    c34["ms"].items())
        + f" (one device {c34['one_ms']:.2f} ms, host wall a call), halo "
        f"{c34['halo']} samples: equal to one device's {c34['samples_out']} "
        f"samples")
    p34 = s34["profile"]
    log(f"[34] profile of one sharded {p34['seconds']:g} s segment "
        f"({p34['shards']} shards, chunked): {p34['kernels']} kernel "
        f"events, {p34['peer_copies']} peer copies, {p34['nccl']} NCCL "
        f"kernels, memcpy kinds {p34['memcpy']}")
    w34 = s34["scaling"]
    log(f"[34] weak scaling, 12 channels a shard, chunked, "
        f"{w34['span_s']:g} s spans, {w34['kind']}: "
        + ", ".join(f"{n} shards {r['rate']:.4e} channel-samples/s "
                    f"(wall {r['wall_s']:.4f} s, efficiency "
                    f"{r['efficiency']:.3f})" for n, r in w34["rates"].items())
        + f" | {time.perf_counter() - t0:.1f} s")

    # ---- 35. process_stream through the conf's front end ----
    t0 = time.perf_counter()
    s35 = phase_stream_front_end(dev, cc, tc, scen)
    for fmt, r in s35.items():
        log(f"[35] process_stream, conf/{r['conf']} as written, raw {fmt} at "
            f"{r['source_fs_hz'] / 1e6:g} Msps through its front end ("
            f"{r['taps']} taps, D={r['decim']}): {r['signal_s']:.2f} s of "
            f"signal, RTF {r['rtf']:.2f} ({r['wall_s']:.2f} s), channels "
            f"{r['channels']}, bit-synced {r['bit_synced']}, xlate_fir "
            f"launches "
            f"{r['launches_xlate_fir']} == segments {r['segments']}, "
            f"launches chunk_corr {r['launches_chunk_corr']} track_chain "
            f"{r['launches_track_chain']} == chunks {r['chunks']}; the first "
            f"segment against xlate_fir_plain: max |diff| "
            f"{r['first_max_abs_diff']:.3e} of RMS {r['first_rms']:.3e}, "
            f"{r['first_bits_equal']:.6f} of the outputs bit for bit "
            f"(capture made on the card in {r['gen_s']:.2f} s)")
    log(f"    | {time.perf_counter() - t0:.1f} s")

    if not SYMBOLS["launches"] > 0 or 20 not in {
            sh["shape"][2] for sh in SYMBOLS["shapes"]}:
        raise AssertionError(f"symbol_slots on the main path: "
                             f"{SYMBOLS['launches']} launches, shapes "
                             f"{[sh['shape'] for sh in SYMBOLS['shapes']]}")
    log(f"    symbol_slots over the main path's runs: {SYMBOLS['launches']} "
        f"launches == {SYMBOLS['calls']} symbol-grid calls on the card in "
        f"{SYMBOLS['runs']} runs; the first call of each of "
        f"{len(SYMBOLS['shapes'])} shapes (cap, C, N, K) bit for bit "
        f"symbol_slots_plain on its rows: "
        + ", ".join(str(sh["shape"]) for sh in SYMBOLS["shapes"]))

    # launches of each kernel over every path that runs it, each counted
    # with the counters set to 0 just before the run and read just after
    kf_t = {r["what"]: r for r in kf_rows if "ms" in r}
    g_t = {r["what"]: r for r in g_rows if "ms" in r}
    mc_t = next(r for r in mc_rows if "ms" in r)
    sym_t = {r["what"]: r for r in sym_rows if "ms" in r}
    xf_t = {r["what"]: r for r in xf_rows}
    paths = (e2e, cli6, cli7, e1, *cli11.values(), *sec_runs.values(),
             *cli14.values(), glo, mix, dual, *cli18.values(),
             *bds.values(), *cli20.values(), s28["ishort"],
             s28["2bits_cpx"], r29, c30, a31["supl"], a31["cold"],
             a31["assist"], a31["hot"], *p32.values(), r33["base"],
             r33["DGNSS"], r33["Kinematic"], *s34["chunked_runs"],
             *s35.values())
    src = "gnss_sdr_1_tpu_torch/csrc/"
    shapes = {**k_rep["sec"], "1G": k_rep["glo"], "2S": k_rep["l2c"]}
    kernels = [{
        "name": "chunk_corr", "route": "cuda",
        "source": src + "chunk_corr.cuh",
        "replaces": "gnss_sdr_1_tpu/track/engine.py:828",
        "launches": sum(p["launches_chunk_corr"] for p in paths),
        "max_abs_err": cr["max_abs_err"], "ms": cr["ms"],
        "plain_ms": cr["plain_ms"], "bound_ms": cr["bound_ms"],
        "bound_by": cr["bound_by"], "library_ms": cr["library_ms"],
        "bound_bytes_ms": cr["bound_bytes_ms"],
        "bound_tf32_ms": cr["bound_tf32_ms"], "passes": cr["passes"],
        "cluster": cr["G"],
        "e1_ms": e1c["ms"], "e1_bound_ms": e1c["bound_ms"],
        "e1_plain_ms": e1c["plain_ms"], "e1_library_ms": e1c["library_ms"],
        "e1_bound_tf32_ms": e1c["bound_tf32_ms"],
        **_shape_keys(shapes, "corr"),
    }, {
        "name": "track_chain", "route": "cuda",
        "source": src + "track_chain.cu",
        "replaces": "gnss_sdr_1_tpu/ops/pallas_chain.py:503",
        "launches": sum(p["launches_track_chain"] for p in paths),
        "max_abs_err": ch["max_abs_err"], "ms": ch["ms"],
        "plain_ms": ch["plain_ms"], "bound_ms": ch["bound_ms"],
        "bound_by": ch["bound_by"], "library_ms": None,
        "e1_ms": e1h["ms"], "e1_bound_ms": e1h["bound_ms"],
        "e1_plain_ms": e1h["plain_ms"], "e1_library_ms": None,
        **_shape_keys(shapes, "chain"),
        "sec_launches": {sig: r["sec_chunks"] for sig, r in
                         {**sec_runs, **bds}.items()},
        "fdma_launches": glo["offset_chunks"],
        "instances_checked": len(k_rep["instances"]),
    }, {
        "name": "kf_block", "route": "cuda", "source": src + "kf_block.cu",
        "replaces": "gnss_sdr_1_tpu/track/kf.py:425",
        "launches": sum(p["launches_kf_block"] for p in (cli8, cli8k, e1kf)),
        "max_abs_err": max(r["max_abs_err"] for r in kf_rows),
        "corr_raw_max_abs_err": max(r["corr_raw"] for r in kf_rows),
        "ms": kf_t["GPS"]["ms"], "plain_ms": kf_t["GPS"]["plain_ms"],
        "bound_ms": kf_t["GPS"]["bound_ms"],
        "bound_by": kf_t["GPS"]["bound_by"], "library_ms": None,
        **{f"{k}_{key}": kf_t[w][key]
           for k, w in (("gps26", "GPS 2.6 Msps"), ("e1", "E1B"),
                        ("c1", "GPS C=1"), ("c20", "GPS C=20"))
           for key in ("ms", "plain_ms", "bound_ms")},
        "geometry": {w: {k: r[k] for k in ("n_cta", "threads", "cpc",
                                           "smem", "prefetch")}
                     for w, r in kf_t.items()},
        **{k: kf_t["GPS"][k] for k in ("seg_us_per_epoch", "seg_bound_ms",
                                       "stage_share", "stage_us_per_epoch",
                                       "serial_floor_ms")},
        "device_us_per_epoch": {
            "cli_kf": cli8["kf_device_us_per_epoch"],
            "gps_l1_kalman": cli8k["kf_device_us_per_epoch"],
            "e1b_kf": e1kf["kf_device_us_per_epoch"]},
        "shapes_checked": len(kf_rows),
    }, {
        "name": "gather_block", "route": "cuda",
        "source": src + "gather_block.cu",
        "replaces": "gnss_sdr_1_tpu/track/engine.py:786",
        "launches": sum(p["launches_gather_block"]
                        for p in (g23, cli26, *sys_runs.values(),
                                  s28["gather"], *s34["gather_runs"])),
        "max_abs_err": max(r["max_abs_err"] for r in g_rows),
        "corr_raw_max_abs_err": max(r["corr_raw"] for r in g_rows),
        "ms": g_t["GPS"]["ms"], "plain_ms": g_t["GPS"]["plain_ms"],
        "bound_ms": g_t["GPS"]["bound_ms"],
        "bound_by": g_t["GPS"]["bound_by"], "library_ms": None,
        **{f"{k}_{key}": g_t[w][key]
           for k, w in (("e1", "E1B"), ("l5", "L5 NH10"), ("b1", "B1I NH20"),
                        ("glo", "GLONASS FDMA"), ("l2c", "L2C"),
                        ("c1", "GPS C=1"), ("c20", "GPS C=20"))
           for key in ("ms", "plain_ms", "bound_ms")},
        "seg_us_per_epoch": g_t["GPS"]["seg_us_per_epoch"],
        "seg_bound_ms": g_t["GPS"]["seg_bound_ms"],
        "serial_floor_ms": g_t["GPS"]["serial_floor_ms"],
        "stage_us_per_epoch": g_t["GPS"]["stages"]["us"],
        "device_us_per_epoch": {
            "e2e": g23["device_us_per_epoch"],
            "cli": cli26["device_us_per_epoch"],
            **{k[4:]: r["device_us_per_epoch"]
               for k, r in sys_runs.items()}},
        "geometry": {r["what"]: {k: r[k] for k in ("n_cta", "threads", "cpc",
                                                   "smem", "prefetch")}
                     for r in g_rows},
        "shapes_checked": len(g_rows), "instances_checked": len(g_inst),
    }, {
        "name": "multicorrelate", "route": "cuda",
        "source": src + "multicorrelate.cuh",
        "replaces": "gnss_sdr_1_tpu/ops/multicorrelator.py:36",
        "launches": tcp["launches_multicorrelate"],
        "max_abs_err": max(r["max_abs_err"] for r in mc_rows),
        "ms": mc_t["ms"], "plain_ms": mc_t["plain_ms"],
        "bound_ms": mc_t["bound_ms"], "bound_by": mc_t["bound_by"],
        "library_ms": None, "host_us": mc_t["host_us"],
        "empty_ms": mc_t["empty_ms"],
        **{f"tcp_{k}": mc_t["tcp_shape"][k]
           for k in ("ms", "plain_ms", "bound_ms", "host_us", "empty_ms")},
        "cluster": mc_t["G"], "cycles_per_sample": {
            k: v["cycles_per_sample"]
            for k, v in mc_t["stages"]["probes"].items()},
        "shapes_checked": len(mc_rows),
    }, {
        "name": "symbol_slots", "route": "cuda",
        "source": src + "symbol_slots.cuh",
        "replaces": "gnss_sdr_1_tpu/track/engine.py:1318",
        "launches": SYMBOLS["launches"], "engine_calls": SYMBOLS["calls"],
        "runs": SYMBOLS["runs"], "max_abs_err": 0.0,
        "ms": sym_t["GPS C=8"]["ms"],
        "events_ms": sym_t["GPS C=8"]["events_ms"],
        "plain_ms": sym_t["GPS C=8"]["plain_ms"],
        "bound_ms": sym_t["GPS C=8"]["bound_ms"],
        "bound_by": sym_t["GPS C=8"]["bound_by"], "library_ms": None,
        **{f"e1b_{k}": sym_t["E1B C=4"][k]
           for k in ("ms", "events_ms", "plain_ms", "bound_ms")},
        "shapes_checked": len(sym_rows),
        "main_path_shapes": [list(r["shape"]) for r in SYMBOLS["shapes"]],
    }, {
        "name": "xlate_fir", "route": "cuda",
        "source": src + "xlate_fir.cu",
        "replaces": "gnss_sdr_1_tpu/condition/filters.py:92 (the whole "
                    "capture's Conditioner; no TPU kernel, no stream "
                    "front end)",
        "launches": sum(r["launches_xlate_fir"] for r in s35.values()),
        "segments": sum(r["segments"] for r in s35.values()),
        "max_abs_err": max(r["err"] for r in xf_rows),
        "ms": xf_t["NSR cell"]["ms"],
        "events_ms": xf_t["NSR cell"]["events_ms"],
        "plain_ms": xf_t["NSR cell"]["plain_ms"],
        "bound_ms": xf_t["NSR cell"]["bound_ms"],
        "bound_by": xf_t["NSR cell"]["bound_by"], "library_ms": None,
        **{f"ishort_{k}": xf_t["GPS ishort cell"][k]
           for k in ("ms", "events_ms", "plain_ms", "bound_ms")},
        "shapes_checked": len(xf_rows),
        "main_path_bits_equal": {f: r["first_bits_equal"]
                                 for f, r in s35.items()},
    }]
    report = {"card": smi, "build_s": build_s, "ptxas": ptxas,
              "kernels": k_rep, "acquisition": acq, "engine": eng,
              "e2e": e2e, "cli_passthrough": cli6, "cli_if": cli7,
              "cli_kf": cli8, "acq_variants": acqv, "e1_e2e": e1,
              "cli_galileo": cli11, "generator": twin, "sec": sec_runs,
              "cli_sec": cli14, "glonass": glo, "mixed": mix, "dual": dual,
              "cli_multi": cli18, "beidou": bds, "cli_beidou": cli20,
              "kf_kernel": kf_rows, "cli_kalman": cli8k, "e1_kf": e1kf,
              "gather_kernel": g_rows, "gather_instances": g_inst,
              "multicorrelate": mc_rows, "symbol_kernel": sym_rows,
              "xlate_kernel": xf_rows, "stream_front_end": s35,
              "symbols_main_path": SYMBOLS, "gather_e2e": g23,
              "gather_system": sys_runs, "cli_gather": cli26, "tcp": tcp,
              "stream": s28, "rtl_tcp": r29, "checkpoint": c30,
              "agnss": a31, "ppp": p32, "rtk": r33, "sharded": s34,
              "total_s": time.perf_counter() - t_all}
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1, default=float))
    log(f"    total {report['total_s']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# phase 1: what ptxas reports
# ---------------------------------------------------------------------------

_KERNEL_NAMES = {"18track_chain_kernel": "track_chain",
                 "17chunk_corr_kernel": "chunk_corr",
                 "15kf_block_kernel": "kf_block",
                 "19gather_block_kernel": "gather_block",
                 "21multicorrelate_kernel": "multicorrelate",
                 "19symbol_slots_kernel": "symbol_slots",
                 "16xlate_fir_kernel": "xlate_fir"}


def build_report() -> dict:
    """Build every library (one nvcc each, started together, even where a
    build of the same sources exists: the report needs ptxas) and check
    what ptxas reports: every kernel is there (16 chain, 2 correlator, 4
    KF, 16 gather and 4 multicorrelator instances, and the symbol-grid
    kernel: built into both walks' libraries under one name, one entry of
    the report; 12 instances of the stream front end's, four input formats
    by three tile sizes); the chain's instances use no local memory,
    the KF's, the gather walk's, the symbol grid's and the front end's
    spill nothing."""
    from gnss_sdr_1_tpu_torch.ops import _build

    _build.build_all(force=True)
    for lib in _build._ENTRIES:
        _build._load(lib)
    ptxas = ptxas_report("\n".join(_build.BUILD_LOG[lib]["ptxas"]
                                   for lib in _build._ENTRIES))
    want = {"track_chain": 16, "chunk_corr": 2, "kf_block": 4,
            "gather_block": 16, "multicorrelate": 4, "symbol_slots": 1,
            "xlate_fir": 12}
    got = {k: sum(n.split("<")[0] == k for n in ptxas) for k in want}
    if any(got[k] < n for k, n in want.items()):
        raise AssertionError(f"ptxas report lacks a kernel: {got}")
    for name, r in ptxas.items():
        if name.startswith("track_chain") and (
                r["stack"] or r["spill_stores"] or r["spill_loads"]):
            raise AssertionError(f"track_chain uses local memory: {r}")
        if name.startswith(("kf_block", "gather_block", "multicorrelate",
                            "symbol_slots", "xlate_fir")) \
                and (r["spill_stores"] or r["spill_loads"]):
            raise AssertionError(f"{name} spills: {r}")
    return ptxas


def ptxas_report(text: str) -> dict:
    """Registers, stack frame and spills of every kernel instance in
    `nvcc -Xptxas -v` output, keyed by a readable name (template arguments
    of the chain: K, PLL order, secondary-code data flag, secondary row)."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = None
            for mangled, short in _KERNEL_NAMES.items():
                if mangled in m.group(1):
                    args = re.findall(r"L[ib](\d+)E", m.group(1))
                    cur = short + "<" + ",".join(args) + ">"
                    out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            cur = None
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against plain
# ---------------------------------------------------------------------------


def _e1_config(**kw):
    """Phase 10's Galileo E1B receiver (tests/test_system_galileo.py's
    configuration on 8 channels)."""
    from gnss_sdr_1_tpu_torch.runtime import ReceiverConfig

    return ReceiverConfig(**{**dict(
        fs_hz=FS_E1, signal_id="1B", n_channels=len(E1_PRNS),
        prn_search=E1_PRNS, acq_dwells=3, pll_bw_hz=15.0, dll_bw_hz=2.0),
        **kw})


def _sec_config(signal, **kw):
    """Phases 12-13's receivers (tests/test_system_l5.py's configuration on
    6 channels; E5a with the CAF acquisition at its threshold and pull-in
    PLL)."""
    from gnss_sdr_1_tpu_torch.runtime import ReceiverConfig

    fs, _, prns = _SEC_CELLS[signal]
    base = dict(fs_hz=fs, signal_id=signal, n_channels=len(prns),
                prn_search=prns, acq_dwells=2, pll_bw_hz=18.0, dll_bw_hz=2.0,
                doppler_step2_hz=15.0, num_doppler_bins_step2=40,
                iono_model="off")
    if signal == "5X":
        base.update(acq_strategy="caf", acq_threshold=CAF_THRESHOLD,
                    pll_bw_hz=CAF_PLL_BW_HZ)
    return ReceiverConfig(**{**base, **kw})


def _bds_config(signal, **kw):
    """Phases 19 and 21's receivers: tests/test_system_beidou.py's
    configuration (three dwells, the two-period window, an 18 Hz PLL, the
    0.2-chip correlator, the 15 Hz second Doppler step over 40 bins) on one
    channel per satellite."""
    from gnss_sdr_1_tpu_torch.runtime import ReceiverConfig

    fs, _, prns = _BDS_CELLS[signal]
    return ReceiverConfig(**{**dict(
        fs_hz=fs, signal_id=signal, n_channels=len(prns), prn_search=prns,
        acq_dwells=3, acq_bit_transition=True, pll_bw_hz=18.0,
        dll_bw_hz=2.0, early_late_space_chips=0.2, doppler_step2_hz=15.0,
        num_doppler_bins_step2=40), **kw})


def _engine(dev, fs=FS, signal="1C", correlator="chunked", n_ch=12):
    """The engine benchmark's tracker (n_ch channels, 16-epoch chunks), or
    for signal '1B' the tracker of phase 10's Galileo E1B receiver at `fs`
    (8 channels, 5 taps, 16-epoch chunks), or for 'L5' / '5X' the tracker
    of phase 12 / 13's receiver (6 channels, the NH10 / CS20 secondary
    rows, 16-epoch chunks), or for 'B1' / 'B3' the tracker of phase 19 / 21's
    receiver (8 / 6 channels, the NH20 rows), or for '1G' a GLONASS L1
    tracker (5 channels, the FDMA slots of GLO_CHECK_KS), or for '2S' a GPS
    L2CM tracker (6 channels, 20 ms epochs); on `correlator`."""
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
    from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine

    c = {"correlator": correlator}
    if signal == "1B":
        return Receiver(_e1_config(fs_hz=fs, **c), device=dev).trk
    if signal in ("L5", "5X"):
        return Receiver(_sec_config(signal, fs_hz=fs, **c), device=dev).trk
    if signal in ("B1", "B3"):
        return Receiver(_bds_config(signal, fs_hz=fs, **c), device=dev).trk
    if signal == "1G":
        return Receiver(ReceiverConfig(
            fs_hz=fs, signal_id="1G", n_channels=len(GLO_CHECK_KS),
            prn_search=tuple(GLO_CHECK_KS),
            fdma_k=tuple(GLO_CHECK_KS.items()), **c), device=dev).trk
    if signal == "2S":
        return Receiver(ReceiverConfig(
            fs_hz=fs, signal_id="2S", n_channels=6,
            prn_search=tuple(range(1, 7)), pll_bw_hz=4.0, dll_bw_hz=0.4,
            **c), device=dev).trk
    codes = np.stack([gps_l1ca_code(p) for p in range(1, n_ch + 1)])
    cfg = TrackConfig(fs_hz=fs, code_length_chips=1023,
                      chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                      n_channels=n_ch, chunk_epochs=16, **c)
    return TrackingEngine(cfg, codes, device=dev)


def _bench_sats(duration_s):
    """The engine benchmark's 12 satellites (bench.py scenario, seed 42)."""
    from gnss_sdr_1_tpu_torch.siggen import SatParams

    rng = np.random.default_rng(42)
    return [SatParams(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),
                      delay_chips=float(rng.uniform(0, 1023)), cn0_dbhz=44.0,
                      nav_bits=rng.choice([-1.0, 1.0],
                                          size=int(duration_s * 50) + 8))
            for p in range(1, 13)]


def _e1_sats(duration_s):
    """8 Galileo E1B satellites for the kernel checks (seed 43; delays in
    2.046 MHz sinBOC half-chips, one symbol per 4 ms)."""
    from gnss_sdr_1_tpu_torch.siggen import SatParams

    rng = np.random.default_rng(43)
    return [SatParams(prn=p, doppler_hz=float(rng.uniform(-3500, 3500)),
                      delay_chips=float(rng.uniform(0, 8184)), cn0_dbhz=48.0,
                      nav_bits=rng.choice([-1.0, 1.0],
                                          size=int(duration_s * 250) + 8))
            for p in E1_PRNS]


def _sec_sats(signal, duration_s):
    """The satellites of `signal` for the kernel checks: 6 of L5 / E5a
    (seed 44 / 45), 8 of B1I or 6 of B3I (seed 49 / 50); delays in the
    signal's chips; the data symbols times the secondary code (NH10, CS20,
    NH20) as one 1 kbps stream, so epoch k of a channel activated at the
    truth carries secondary chip k mod the code length."""
    from gnss_sdr_1_tpu_torch.codes import BEIDOU_NH20, NH10
    from gnss_sdr_1_tpu_torch.codes.galileo_e5 import galileo_e5ai_secondary
    from gnss_sdr_1_tpu_torch.constants import SIGNALS
    from gnss_sdr_1_tpu_torch.siggen import SatParams

    sec = np.asarray({"L5": NH10, "5X": galileo_e5ai_secondary(),
                      "B1": BEIDOU_NH20, "B3": BEIDOU_NH20}[signal],
                     np.float64)
    n_sym = int(duration_s * 1000) // len(sec) + 2
    rng = np.random.default_rng({"L5": 44, "5X": 45, "B1": 49,
                                 "B3": 50}[signal])
    prns = {**_SEC_CELLS, **_BDS_CELLS}[signal][2]
    n_chips = SIGNALS[signal].code_length_chips
    return [SatParams(prn=p, doppler_hz=float(rng.uniform(-3500, 3500)),
                      delay_chips=float(rng.uniform(0, n_chips)),
                      cn0_dbhz=48.0,
                      nav_bits=np.repeat(rng.choice([-1.0, 1.0], n_sym),
                                         len(sec)) * np.tile(sec, n_sym),
                      bit_rate_override_bps=1000.0)
            for p in prns]


def _activate_all(eng, sats):
    """Every channel at its satellite's true delay and Doppler (delays in
    the replica's chips: 1.023 MHz for GPS, 2.046 MHz for E1 sinBOC), with
    its FDMA carrier offset as the NCO bias."""
    fs = eng.cfg.fs_hz
    rate = eng.cfg.chip_rate_chips_s * eng.cfg.code_samples_per_chip
    st = eng.init_state()
    for ch, s in enumerate(sats):
        st = eng.activate_channel(st, ch, ch, s.delay_chips / rate * fs,
                                  s.doppler_hz, 0, 0,
                                  carr_offset_hz=s.carrier_offset_hz)
    return st


def _glo_sats(duration_s):
    """Five GLONASS slots on the FDMA carriers of GLO_CHECK_KS for the
    kernel checks (seed 46; 100 sps meander symbols)."""
    from gnss_sdr_1_tpu_torch.siggen import SatParams

    rng = np.random.default_rng(46)
    return [SatParams(prn=p, doppler_hz=float(rng.uniform(-3500, 3500)),
                      delay_chips=float(rng.uniform(0, 511)), cn0_dbhz=47.0,
                      nav_bits=rng.choice([-1.0, 1.0],
                                          int(duration_s * 100) + 8),
                      carrier_offset_hz=562.5e3 * k,
                      bit_rate_override_bps=100.0)
            for p, k in GLO_CHECK_KS.items()]


def _l2c_sats(duration_s):
    """Six GPS L2CM satellites for the kernel checks (seed 47; one CNAV
    symbol per 20 ms code period)."""
    from gnss_sdr_1_tpu_torch.siggen import SatParams

    rng = np.random.default_rng(47)
    return [SatParams(prn=p, doppler_hz=float(rng.uniform(-2500, 2500)),
                      delay_chips=float(rng.uniform(0, 10230)),
                      cn0_dbhz=47.0,
                      nav_bits=rng.choice([-1.0, 1.0],
                                          int(duration_s * 50) + 8),
                      bit_rate_override_bps=50.0)
            for p in range(1, 7)]


def _gen(sats, duration_s, key, fs=FS, signal="1C"):
    """A synthetic capture, cached in CACHE: GPS L1 C/A, or Galileo E1B
    generated as the sinBOC 'virtual' code at 2.046 MHz with one I/NAV
    symbol per 4 ms code period (tests/test_system_galileo.py), or GPS L5 /
    Galileo E5a / BeiDou B1I / B3I with the secondary-coded symbols as a
    1 kbps stream."""
    import dataclasses

    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code, tracking_replica
    from gnss_sdr_1_tpu_torch.constants import GALILEO_E1B, GPS_L1_CA, SIGNALS
    from gnss_sdr_1_tpu_torch.siggen import generate_baseband

    CACHE.mkdir(exist_ok=True)
    path = CACHE / f"{key}.npy"
    if path.exists():
        return np.load(path)
    if signal == "1B":
        spec = dataclasses.replace(GALILEO_E1B, code_rate_chips_s=2.046e6,
                                   code_length_chips=2 * 4092,
                                   bit_rate_bps=250.0)
        codes = {s.prn: tracking_replica("1B", s.prn)[0] for s in sats}
    elif signal in ("L5", "5X", "B1", "B3"):
        spec = dataclasses.replace(SIGNALS[signal], bit_rate_bps=1000.0)
        codes = {s.prn: tracking_replica(signal, s.prn)[0] for s in sats}
    else:
        spec, codes = GPS_L1_CA, {s.prn: gps_l1ca_code(s.prn) for s in sats}
    x = generate_baseband(spec, sats, codes, fs, duration_s, noise=True)
    np.save(path, x)
    return x


def _chain_diff(tc, got, want, rows_out=None):
    """Max |diff| of the float outputs, scaled check per row; int rows and
    flags exact.  Raises when a row is over its tolerance.  `rows_out`
    collects (output, row, |diff|, tolerance) per float row."""
    worst = 0.0
    names = ("out_f", "out_i", "out_corr", "fst", "ist")
    for name, g, w in zip(names, got, want):
        g = g.double().cpu()
        w = w.double().cpu()
        if name in ("out_i", "ist"):
            if not torch.equal(g, w):
                raise AssertionError(f"chain kernel int rows differ: {name}")
            continue
        for r in range(g.shape[-2]):
            gr, wr = g[..., r, :], w[..., r, :]
            d = float((gr - wr).abs().max())
            if name == "out_f" and r in (tc.O_VALID, tc.O_ACTIVE):
                if d != 0.0:
                    raise AssertionError(f"chain kernel flag row {r} differs")
                continue
            # float32 rows: atol 1e-4 of the row's scale (the kernel and
            # the plain version round transcendentals and sums differently)
            tol = 1e-4 * max(1.0, float(wr.abs().max()))
            if rows_out is not None:
                rows_out.append((name, r, d, tol))
            if not d <= tol:
                raise AssertionError(
                    f"chain kernel {name} row {r}: |diff| {d:.3e} > {tol:.3e}")
            worst = max(worst, d)
    return worst


def _corr_diff(got, want, want_cpu):
    """chunk_corr: slice origins and step0 exact (the chain's int rows
    depend on them) against the plain version on the CPU, which divides
    as the kernel does (on CUDA tensors torch divides by a Python scalar as
    a multiply by the float reciprocal); lag windows within 1e-4 of max|z|
    of the plain version on the card (the kernel's sums run in another
    order than cuBLAS').  Returns (max |diff|, max|z|)."""
    zr, zi, s_reg, step0 = (t.cpu() for t in got)
    wr, wi, ws, _ = (t.cpu() for t in want)
    _, _, s_cpu, step0_cpu = want_cpu
    if not (torch.equal(s_reg, ws) and torch.equal(s_reg, s_cpu)):
        raise AssertionError("chunk_corr slice origins differ")
    if not torch.equal(step0, step0_cpu):
        raise AssertionError("chunk_corr step0 differs from the CPU's")
    scale = float(max(wr.abs().max(), wi.abs().max()))
    d = float(max((zr - wr).abs().max(), (zi - wi).abs().max()))
    if not d <= 1e-4 * scale:
        raise AssertionError(f"chunk_corr |diff| {d:.3e} > 1e-4 x max|z| "
                             f"{scale:.3e}")
    return d, scale


def _time_cuda(fn, n):
    """Per-call time from CUDA events around n back-to-back calls."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _trace(fn, n):
    """Every event of a torch.profiler trace of n calls of fn (after one
    call outside it), the calls synchronised at the end."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return _trace_events(prof)


def _device_ms(fn, n, tries=3):
    """Device time per call: the kernels' durations in a profiler trace of
    n calls, summed, over n.  A trace without a kernel event (the profiler
    loses them now and then, PERF.md section 7) is taken again, `tries`
    times in all, then NoKernelEvent."""
    for _ in range(tries):
        us = sum(e["dur"] for e in _trace(fn, n)
                 if e.get("cat") == "kernel")
        if us > 0:
            return us / n * 1e-3
    raise NoKernelEvent(f"{tries} profiler traces hold no kernel event")


def _event_ms(fn, n, name, tries=3):
    """The mean device time of the kernels whose name holds `name` in a
    profiler trace of n calls of fn, over the events the trace holds (the
    profiler loses some now and then, PERF.md section 7), and the trace's
    events; a trace without such an event is taken again, `tries` times
    in all, then NoKernelEvent."""
    for _ in range(tries):
        events = _trace(fn, n)
        durs = [e["dur"] for e in events
                if e.get("cat") == "kernel" and name in e["name"]]
        if durs:
            return sum(durs) / len(durs) * 1e-3, events
    raise NoKernelEvent(f"{tries} profiler traces hold no kernel event of "
                        f"{name}")


def _by_name(events, n, cat="kernel"):
    """{name: (device ms per call, events per call)} of the trace events of
    category `cat` over n calls."""
    out = {}
    for e in events:
        if e.get("cat") == cat:
            ms, k = out.get(e["name"], (0.0, 0))
            out[e["name"]] = (ms + e["dur"] / n * 1e-3, k + 1)
    return {k: (ms, cnt / n) for k, (ms, cnt) in out.items()}


class NoKernelEvent(AssertionError):
    """A profiler trace without the kernel's events."""


def _midtrack(dev, fs, signal="1C"):
    """The engine at `fs` after 0.25 s of tracking on the engine benchmark's
    scenario (or, for '1B', on 8 Galileo E1B satellites; for 'L5' / '5X' /
    'B1' / 'B3', 0.253 s on 6 (B1I: 8) satellites, then every channel
    switched to the extended mode with the secondary wipe at its true code
    index, which is not 0;
    for '1G', on 5 GLONASS slots on their FDMA carriers; for '2S', on 6
    L2CM satellites, made on the card), and the inputs of its next chunk:
    (engine, seg, rows, slot, sec_rows, fst, ist).  The sample limit ends
    inside the third chunk (GPS, L5, E5a, B1I, B3I, GLONASS: 40 ms; E1:
    160 ms; L2C: 800 ms)."""
    head = 0.25
    if signal == "1B":
        dur = 0.5
        sats = _e1_sats(dur)
    elif signal in ("L5", "5X", "B1", "B3"):
        dur, head = 0.3, 0.253
        sats = _sec_sats(signal, dur)
    elif signal in ("1G", "2S"):
        dur = 0.3 if signal == "1G" else 1.25
        sats = (_glo_sats if signal == "1G" else _l2c_sats)(dur)
    else:
        dur = 0.3
        sats = _bench_sats(dur)
    if signal in ("1G", "2S"):
        from gnss_sdr_1_tpu_torch.codes import tracking_replica
        from gnss_sdr_1_tpu_torch.constants import SIGNALS

        xd = generate_on_card(SIGNALS[signal], sats, {
            s.prn: tracking_replica(signal, s.prn)[0] for s in sats}, fs,
            dur, dev, seed=48)
    else:
        xd = torch.as_tensor(_gen(
            sats, dur, f"kernel_chunk_{signal}_{fs:.0f}_{dur:g}s_v1", fs,
            signal), device=dev)
    eng = _engine(dev, fs, signal)
    st = _activate_all(eng, sats)
    span = int(fs * head)
    st, _ = eng.track_capture(xd[: span + eng.cfg.epoch_samples_max], st,
                              span)
    if signal in ("L5", "5X", "B1", "B3"):
        n = eng.chain_spec.sec_len
        phases = st.epochs_in_track.cpu().numpy() % n
        if not (phases > 0).all() or not bool(st.active.all()):
            raise AssertionError(f"{signal} kernel check: secondary phases "
                                 f"{phases}, active {st.active}")
        for ch, ph in enumerate(phases):
            st = eng.enable_extended(st, ch, (n - int(ph)) % n,
                                     sec_phase=int(ph))
    seg = eng._pad_for_chunks(xd[span:])
    chunk_s = eng.chain_spec.E * eng.cfg.code_period_s
    fst, ist = eng._pack_rows(st, int(fs * (CAPTURE_CHUNKS - 0.5) * chunk_s))
    slot = st.prn_slot.to(torch.int32).contiguous()
    sec_rows = eng._sec[slot.long()].T.contiguous()
    return eng, seg, eng._rows, slot, sec_rows, fst, ist


def _check_kernels(dev, cc, tc, inputs, g):
    """Both kernels against their plain versions on a mid-track chunk and
    on random inputs (the chain on the correlator's mid-track output; the
    chain's plain version run on the CPU), and the capture entry over
    CAPTURE_CHUNKS chunks in one call against the plain chunk loop on the
    CPU.  Raises on any disagreement."""
    from gnss_sdr_1_tpu_torch.ops import track_capture as tcap

    eng, seg, rows, slot, sec_rows, fst, ist = inputs
    spec, cspec = eng.chain_spec, eng.corr_spec

    # ---- chunk_corr: the mid-track chunk and random samples ----
    noise = torch.randn((seg.shape[0], 2), generator=g) * 100.0
    seg_rand = torch.view_as_complex(noise).to(dev)
    corr_out, corr_err, corr_scale = {}, {}, {}
    for label, samples in (("random", seg_rand), ("track", seg)):
        before = cc.launches
        got = cc.chunk_corr(cspec, samples, rows, slot, fst, ist)
        torch.cuda.synchronize()
        if cc.launches != before + 1:
            raise AssertionError("chunk_corr wrapper did not launch")
        want = cc.chunk_corr_plain(cspec, samples, rows, slot, fst, ist)
        want_cpu = cc.chunk_corr_plain(
            cspec, *(t.cpu() for t in (samples, rows, slot, fst, ist)))
        corr_err[label], corr_scale[label] = _corr_diff(got, want, want_cpu)
        corr_out[label] = got

    # ---- track_chain: the correlator's mid-track output, random z ----
    zr_t, zi_t, s_reg, step0 = corr_out["track"]
    track_args = (zr_t, zi_t, s_reg, step0, sec_rows, fst, ist)
    zr = torch.randn(zr_t.shape, generator=g) * 100.0
    zi = torch.randn(zi_t.shape, generator=g) * 100.0
    rand_args = (zr.to(dev), zi.to(dev)) + track_args[2:]
    errs, rows_diff = {}, {}
    for label, args in (("random", rand_args), ("track", track_args)):
        before = tc.launches
        got = tc.chain(spec, *args)
        torch.cuda.synchronize()
        if tc.launches != before + 1:
            raise AssertionError("chain wrapper did not launch the kernel")
        # the plain version on the CPU divides as the kernel does (on CUDA
        # tensors torch divides by a Python scalar as a multiply by the
        # reciprocal: an ulp in the tap position that the steep sinBOC
        # peak of the E1 shape turns into ~1e-4 of the prompt's scale)
        want = tc.chain_plain(spec, *(t.cpu() for t in args))
        rows_diff[label] = []
        errs[label] = _chain_diff(tc, got, want, rows_diff[label])

    # ---- the capture entry: both kernels over several chunks in one call,
    #      against the plain chunk loop on the CPU ----
    cap_args = (seg, rows, slot, sec_rows, fst, ist)
    n_cap = CAPTURE_CHUNKS
    before = (cc.launches, tc.launches)
    got = tcap.track_capture(spec, cspec, n_cap, *cap_args)
    torch.cuda.synchronize()
    if (cc.launches, tc.launches) != (before[0] + n_cap, before[1] + n_cap):
        raise AssertionError("track_capture did not launch both kernels "
                             "for every chunk")
    want = tcap.track_capture_plain(spec, cspec, n_cap,
                                    *(t.cpu() for t in cap_args))
    errs["capture"] = _chain_diff(tc, got, want)
    n_valid_cap = int(want[0][:, tc.O_VALID].sum())
    if not n_valid_cap > 0:
        raise AssertionError("the capture check tracked no valid epoch")
    return {"corr_err": corr_err, "corr_scale": corr_scale,
            "chain_err": errs, "rows": rows_diff, "track_args": track_args,
            "capture_valid_epochs": n_valid_cap}


def _time_shape(cc, tc, inputs, track_args):
    """Device ms per launch of both kernels at one shape (profiler over 200
    launches), their times from the host, the plain versions' times, the
    torch.bmm pair the correlator replaces, and each kernel's bound."""
    eng, seg, rows, slot, sec_rows, fst, ist = inputs
    spec, cspec = eng.chain_spec, eng.corr_spec
    wr, wi, _, _ = cc.windows_plain(cspec, seg, fst, ist)
    bank_t = cc.replica_bank(cspec, rows, slot)

    def corr_call():
        cc.chunk_corr_cuda(cspec, seg, rows, slot, fst, ist)

    def bmm_pair():
        torch.bmm(wr, bank_t)
        torch.bmm(wi, bank_t)

    corr_ms = _device_ms(corr_call, 200)
    corr_host = _time_cuda(corr_call, 500)
    corr_plain = _time_cuda(
        lambda: cc.chunk_corr_plain(cspec, seg, rows, slot, fst, ist), 20)
    bmm_ms = _device_ms(bmm_pair, 200)
    # least time: bytes (each channel's segment, its replica row, the state
    # rows read; the lag windows, slice origins and step0 written) against
    # operations (the lag products over this chunk's wiped samples) at the
    # float32 FMA rate, the measure kept across PRs; beside it the bytes
    # alone and the TF32 bound: the kernel's passes of the lag products at
    # the tensor cores' TF32 rate, the wipe at the float32 rate
    C, E, LW = cspec.C, cspec.E, cspec.LW
    n_wiped = int(((wr != 0) | (wi != 0)).sum())
    c_bytes = (C * cspec.seg_len * 8 + C * cspec.QW * 4
               + (fst.shape[0] + ist.shape[0]) * C * 4
               + (2 * C * E * LW + C * E + C) * 4)
    c_ops = 4 * LW * n_wiped + WIPE_OPS_PER_SAMPLE * n_wiped
    tb, to = c_bytes / PEAK_BYTES_S * 1e3, c_ops / PEAK_F32_S * 1e3
    p = cc.corr_params(cspec)
    t_tf32 = (p.passes * 4 * LW * n_wiped / PEAK_TF32_S
              + WIPE_OPS_PER_SAMPLE * n_wiped / PEAK_F32_S) * 1e3
    corr = {
        "ms": corr_ms, "ms_host": corr_host,
        "plain_ms": corr_plain, "library_ms": bmm_ms,
        "library": "torch.bmm pair on the plain path's wiped windows (the "
                   "product alone)",
        "bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to
        else "operations", "bound_bytes": c_bytes, "bound_ops": c_ops,
        "bound_bytes_ms": tb, "bound_f32_ms": to,
        "bound_tf32_ms": t_tf32,
        "wiped_samples": n_wiped, "NW": cspec.NW, **_corr_split(cc, cspec)}

    chain_ms = _device_ms(lambda: tc.chain_cuda(spec, *track_args), 200)
    chain_host = _time_cuda(lambda: tc.chain_cuda(spec, *track_args), 500)
    chain_plain = _time_cuda(lambda: tc.chain_plain(spec, *track_args), 5)
    # least time for the same work: bytes the function needs (the 2K lags
    # per plane each epoch reads, state and outputs once) vs operations
    K = spec.K
    sf, si = tc.n_frows(K), tc.N_IROWS
    n_bytes = 4 * (2 * 2 * K * E * C                 # lag reads, I and Q
                   + E * C + C + spec.sec_len * C     # s_reg, step0, sec
                   + 2 * (sf + si) * C                # state in and out
                   + E * (tc.N_OROWS + 2 + 2 * K) * C)  # per-epoch outputs
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = OPS_PER_EPOCH_CHANNEL * E * C / PEAK_F32_S * 1e3
    chain = {
        "ms": chain_ms, "ms_host": chain_host, "plain_ms": chain_plain,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": n_bytes, "E": E, "LW": LW, "C": C, "K": K}
    return corr, chain


def _corr_bounds(r):
    """A correlator row's bounds: the float32 one kept across PRs, the
    bytes, and the operations of its TF32 passes."""
    return (f"bound {r['bound_ms']:.2e} ms ({r['bound_by']}; bytes "
            f"{r['bound_bytes_ms']:.2e}, float32 products "
            f"{r['bound_f32_ms']:.2e}, {r['passes']} TF32 passes "
            f"{r['bound_tf32_ms']:.2e})")


def _corr_split(cc, cspec):
    """The correlator's launch at a shape: the cluster of CTAs a channel
    takes, the tiles each walks, the TF32 passes."""
    p = cc.corr_params(cspec)
    return {"G": p.G, "tiles": p.tiles, "passes": p.passes,
            "split": f"{p.C} clusters of {p.G} CTAs, {p.tiles} tile(s) of "
                     f"{8 * p.TK} samples each, {p.passes} TF32 passes, "
                     f"{p.smem} B"}


def _rate_summary(cc, fs, inp, c):
    """One untimed kernel check at another shape, for the report."""
    cspec = inp[0].corr_spec
    return {"fs": fs, "NW": cspec.NW, "LW": cspec.LW, "K": inp[0].chain_spec.K,
            **_corr_split(cc, cspec),
            "samples_per_chip": fs / inp[0].cfg.chip_rate_chips_s,
            "corr_err": max(c["corr_err"].values()),
            "corr_scale": max(c["corr_scale"].values()),
            "chain_err": max(c["chain_err"]["random"],
                             c["chain_err"]["track"]),
            "capture_err": c["chain_err"]["capture"],
            "capture_valid_epochs": c["capture_valid_epochs"]}


def phase_kernels(dev, cc, tc):
    g = torch.Generator(device="cpu").manual_seed(7)
    # a real chunk taken mid-track at the main path's shapes
    inputs = _midtrack(dev, FS)
    eng = inputs[0]
    spec, cspec = eng.chain_spec, eng.corr_spec
    assert (spec.E, spec.LW, spec.C, spec.K, cspec.NW) == (
        16, 68, 12, 3, 4136), (spec, cspec)
    chk = _check_kernels(dev, cc, tc, inputs, g)
    corr_err, corr_scale, errs = (chk["corr_err"], chk["corr_scale"],
                                  chk["chain_err"])

    # the same checks, untimed, at the other rates the CLI phases run
    other = []
    for fs in CHECK_RATES:
        inp = _midtrack(dev, fs)
        other.append(_rate_summary(cc, fs, inp,
                                   _check_kernels(dev, cc, tc, inp, g)))
    corr_t, chain_t = _time_shape(cc, tc, inputs, chk["track_args"])

    # Galileo E1B: the 5-tap chain and the 4 ms window at phase 10's shape,
    # timed; then at 8.184 Msps, where every CTA of a channel's cluster
    # walks its share of the window in several tiles (untimed)
    e1_in = _midtrack(dev, FS_E1, "1B")
    e_spec, e_cspec = e1_in[0].chain_spec, e1_in[0].corr_spec
    assert (e_spec.E, e_spec.LW, e_spec.C, e_spec.K, e_spec.prompt_index,
            e_cspec.NW) == (16, 69, 8, 5, 2, 16045), (e_spec, e_cspec)
    e1_chk = _check_kernels(dev, cc, tc, e1_in, g)
    e1_corr_t, e1_chain_t = _time_shape(cc, tc, e1_in, e1_chk["track_args"])
    e1 = _rate_summary(cc, FS_E1, e1_in, e1_chk)
    e1.update(corr=e1_corr_t, chain=e1_chain_t, rows=e1_chk["rows"])
    tiled_in = _midtrack(dev, E1_TILED_RATE, "1B")
    if not cc.corr_params(tiled_in[0].corr_spec).tiles > 1:
        raise AssertionError("the tiled E1 check runs in one tile")
    tiled = _rate_summary(cc, E1_TILED_RATE, tiled_in,
                          _check_kernels(dev, cc, tc, tiled_in, g))

    # GPS L5, Galileo E5a, BeiDou B1I (bds_b1i_ibyte.conf's 5 Msps, 8
    # channels, the 0.2-chip correlator) and B3I (12.5 Msps): the
    # secondary-code instances of the chain (NH10, CS20, NH20), timed
    sec, sec_inputs = {}, {}
    for signal, fs in (("L5", FS_L5), ("5X", FS_E5A), ("B1", FS_B1I),
                       ("B3", FS_B3I)):
        s_in = _midtrack(dev, fs, signal)
        s_spec = s_in[0].chain_spec
        n = {"L5": 10, "5X": 20, "B1": 20, "B3": 20}[signal]
        n_ch = 8 if signal == "B1" else 6
        if (s_spec.E, s_spec.C, s_spec.K, s_spec.sec_len, s_spec.sec_data) \
                != (16, n_ch, 3, n, True):
            raise AssertionError(f"{signal} kernel check at {s_spec}")
        if signal == "B1" and s_spec.shifts_chips != (-0.2, 0.0, 0.2):
            raise AssertionError(f"B1I kernel check at {s_spec}")
        ist = s_in[6]
        if not bool((ist[tc.I_SEC_ON] > 0).all()):
            raise AssertionError(f"{signal} kernel check without the wipe")
        s_chk = _check_kernels(dev, cc, tc, s_in, g)
        s_corr, s_chain = _time_shape(cc, tc, s_in, s_chk["track_args"])
        sec[signal] = _rate_summary(cc, fs, s_in, s_chk)
        sec[signal].update(corr=s_corr, chain=s_chain, rows=s_chk["rows"],
                           sec_len=n, C=n_ch,
                           sec_idx=ist[tc.I_SEC_IDX].cpu().tolist())
        sec_inputs[signal] = s_in, s_chk

    # GLONASS L1 at 6.625 Msps: both kernels' first non-zero carrier bias
    # (F_CARR_OFF, one slot at |k| = 5: 2.81 MHz against the +-3.31 MHz
    # band), and GPS L2C at 3 Msps: the 20 ms window of ~60,000 samples
    # split over a cluster of CTAs, each in several tiles; each timed
    new = {}
    for signal, fs in (("1G", FS_GLO_HI), ("2S", FS_L2C)):
        n_in = _midtrack(dev, fs, signal)
        n_spec, n_cspec = n_in[0].chain_spec, n_in[0].corr_spec
        tiles = cc.corr_params(n_cspec).tiles
        offs = n_in[5][tc.F_CARR_OFF].cpu().numpy()
        if (n_spec.K, n_spec.sec_len, n_spec.sec_data) != (3, 1, False):
            raise AssertionError(f"{signal} kernel check at {n_spec}")
        if signal == "1G" and not (np.abs(offs).max() == 562.5e3 * 5
                                   and (offs != 0).sum() == 4):
            raise AssertionError(f"GLONASS kernel check offsets {offs}")
        if signal == "2S" and not (tiles > 1 and n_cspec.NW > 60000):
            raise AssertionError(f"L2C kernel check in {tiles} tiles, "
                                 f"NW={n_cspec.NW}")
        n_chk = _check_kernels(dev, cc, tc, n_in, g)
        n_corr, n_chain = _time_shape(cc, tc, n_in, n_chk["track_args"])
        new[signal] = _rate_summary(cc, fs, n_in, n_chk)
        new[signal].update(corr=n_corr, chain=n_chain, rows=n_chk["rows"],
                           offsets_hz=offs.tolist())

    # every template instance the chain can run, on the E1 (K=5) and L5
    # (K=3) mid-track chunks
    inst = _check_instances(dev, tc, {
        5: (e1_in[0].chain_spec, e1_chk["track_args"]),
        3: (sec_inputs["L5"][0][0].chain_spec,
            sec_inputs["L5"][1]["track_args"])}, g)
    digests = _chain_digests(dev, tc, {
        5: e1_in[0].chain_spec, 3: sec_inputs["L5"][0][0].chain_spec})

    checks = other + [e1, tiled, *sec.values(), *new.values()]
    corr_rep = {
        "err_random": corr_err["random"], "err_track": corr_err["track"],
        "scale_random": corr_scale["random"],
        "scale_track": corr_scale["track"],
        "max_abs_err": max([*corr_err.values()]
                           + [r["corr_err"] for r in checks]), **corr_t}
    chain_rep = {
        "err_random": errs["random"], "err_track": errs["track"],
        "err_capture": errs["capture"], "capture_chunks": CAPTURE_CHUNKS,
        "capture_valid_epochs": chk["capture_valid_epochs"],
        "max_abs_err": max([errs["random"], errs["track"]]
                           + [r["chain_err"] for r in checks]
                           + [r["err"] for r in inst]),
        **chain_t, "rows": chk["rows"]}
    return {"chunk_corr": corr_rep, "track_chain": chain_rep,
            "gps_split": _corr_split(cc, cspec)["split"],
            "other_rates": other, "e1": e1, "e1_tiled": tiled, "sec": sec,
            "glo": new["1G"], "l2c": new["2S"], "instances": inst,
            "chain_digests": digests}


def _instance_cases(tc, bases, g):
    """Each of the 16 template instances <K, ORDER, SEC_DATA, HAS_SEC> that
    chain_kernel_for (csrc/track_chain.cu) can return, on a mid-track chunk
    and on random lag windows: yields (instance name, chain spec, the
    chain's CPU inputs).  `bases`: K -> (chain spec, the mid-track chain
    inputs).  ORDER=2 takes the order-2 loop coefficients with the
    integrator seeded from the Doppler; HAS_SEC runs a secondary code (the
    chunk's own NH10 rows, or a random 20-chip code) with the wipe on in
    every other channel from a non-zero index; SEC_DATA switches the
    Costas discriminator."""
    import dataclasses

    from gnss_sdr_1_tpu_torch.track.loop_filter import fll_pll_coefficients

    w2 = fll_pll_coefficients(35.0, 25.0, 2)
    n2 = fll_pll_coefficients(8.0, 12.0, 2)
    coef = lambda c: (c.w0p, c.w0p2, c.w0p3, c.w0f, c.w0f2, c.a2, c.a3,
                      c.b3)                                     # noqa: E731
    for K, (spec0, args0) in sorted(bases.items()):
        zr, zi, s_reg, step0, sec0, fst0, ist0 = (t.cpu() for t in args0)
        C = spec0.C
        rand = (torch.randn(zr.shape, generator=g) * 100.0,
                torch.randn(zi.shape, generator=g) * 100.0)
        for order in (2, 3):
            for sec_data in (False, True):
                for has_sec in (False, True):
                    spec = dataclasses.replace(spec0, sec_data=sec_data)
                    fst, ist = fst0.clone(), ist0.clone()
                    if order == 2:
                        spec = dataclasses.replace(
                            spec, order=2, wide=coef(w2), narrow=coef(n2))
                        fst[tc.F_CARR_W] = fst[tc.F_DOPPLER]
                        fst[tc.F_CARR_X] = 0.0
                    elif spec.order != 3:
                        raise AssertionError(f"base spec order {spec.order}")
                    if has_sec:
                        sec = sec0 if sec0.shape[0] > 1 else torch.where(
                            torch.rand((20, C), generator=g) < 0.5, -1.0,
                            1.0).to(torch.float32)
                        spec = dataclasses.replace(spec, sec_len=sec.shape[0])
                        ist[tc.I_SEC_ON] = (torch.arange(C) % 2 == 0).to(
                            torch.int32)
                        ist[tc.I_SEC_IDX] = (torch.arange(C, dtype=torch.int32)
                                             * 7 + 3) % sec.shape[0]
                    else:
                        spec = dataclasses.replace(spec, sec_len=1)
                        sec = torch.ones((1, C), dtype=torch.float32)
                        ist[tc.I_SEC_ON] = 0
                        ist[tc.I_SEC_IDX] = 0
                    name = (f"<{K},{order},{str(sec_data).lower()},"
                            f"{str(has_sec).lower()}>")
                    for z in ((zr, zi), rand):
                        yield name, spec, (*z, s_reg, step0, sec.contiguous(),
                                           fst, ist)


def _check_instances(dev, tc, bases, g):
    """Every case of _instance_cases launched through the chain wrapper
    against chain_plain on the CPU (_chain_diff's bars)."""
    rows = {}
    for name, spec, args in _instance_cases(tc, bases, g):
        before = tc.launches
        got = tc.chain(spec, *(t.to(dev) for t in args))
        torch.cuda.synchronize()
        if tc.launches != before + 1:
            raise AssertionError(f"{name}: the chain wrapper did not launch")
        want = tc.chain_plain(spec, *args)
        r = rows.setdefault(name, {"instance": name, "err": 0.0})
        r["err"] = max(r["err"], _chain_diff(tc, got, want))
        r["valid_epochs"] = int(want[0][:, tc.O_VALID].sum())
    if len(rows) != 16:
        raise AssertionError(f"{len(rows)} chain instances checked")
    return list(rows.values())


def _chain_digests(dev, tc, specs):
    """Every output of the 16 chain instances (_instance_cases) on the
    fixed inputs of CHAIN_DIGESTS' .npz (the E1 (K=5) and L5 (K=3)
    mid-track chunks' lag windows and state rows), hashed (SHA-256 of the
    bytes) and held to the digests in its .json, which the chain kernel
    wrote on them before its closure was split: the chain bit for bit the
    same.  `specs`: K -> the chain spec.  Raises when any differs."""
    import hashlib

    data = np.load(CHAIN_DIGESTS.with_suffix(".npz"))
    want = json.loads(CHAIN_DIGESTS.with_suffix(".json").read_text())
    bases = {K: (spec, tuple(torch.from_numpy(data[f"k{K}_{n}"]) for n in (
        "zr", "zi", "s_reg", "step0", "sec", "fst", "ist")))
        for K, spec in specs.items()}
    got = [{"instance": name, "digests": [
        hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()
        for t in tc.chain(spec, *(t.to(dev) for t in args))]}
        for name, spec, args in _instance_cases(
            tc, bases, torch.Generator().manual_seed(3))]
    same = sum(a == b for g, w in zip(got, want["cases"])
               for a, b in zip(g["digests"], w["digests"]))
    total = sum(len(w["digests"]) for w in want["cases"])
    if len(got) != len(want["cases"]) or same != total:
        raise AssertionError(f"chain digests: {same} of {total} outputs of "
                             f"the 16 instances as recorded")
    return {"same": same, "total": total}


# ---------------------------------------------------------------------------
# phase 2b: the KF block kernel against its plain version
# ---------------------------------------------------------------------------


def _kf_engine(signal, fs, n_ch, n_active, order, bayes, n_blocks):
    """A KF engine on the CPU as the receiver builds it for `signal` at `fs`
    (the virtual half-chip basis on E1B), `n_active` channels activated on
    a seeded numpy capture of as many satellites (45 dB-Hz, Dopplers from
    -3 kHz up in steps of 550 Hz, or over the same 6,050 Hz past 12
    satellites, code phases half a sample off the grid), `n_blocks` blocks
    of KF_BLOCK_MS.  Returns (engine, state, samples, base, make), where
    make(n, dev) is the same scenario's first n samples made on `dev` by
    generate_on_card."""
    import dataclasses

    from gnss_sdr_1_tpu_torch.codes import tracking_replica
    from gnss_sdr_1_tpu_torch.constants import SIGNALS
    from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband
    from gnss_sdr_1_tpu_torch.track.kf import KfTrackConfig, KfTrackingEngine

    spec = SIGNALS[signal]
    prns = list(range(1, n_ch + 1))
    reps = {p: tracking_replica(signal, p) for p in prns}
    rate, spc = reps[1][1:]
    codes = np.stack([reps[p][0] for p in prns])
    L = codes.shape[1]
    cfg = KfTrackConfig(
        fs_hz=fs, code_length_chips=L, chip_rate_chips_s=rate,
        carrier_freq_hz=spec.carrier_freq_hz, n_channels=n_ch, order=order,
        early_late_space_chips=0.5 * spc, bayes_run=bayes,
        **(KF_BAYES if bayes else {}))
    eng = KfTrackingEngine(cfg, codes, device="cpu")
    base = int(round(fs * KF_BLOCK_MS * 1e-3))
    n = n_blocks * base + cfg.epoch_samples_max
    half = 0.5 * rate / fs
    step = min(550.0, 6050.0 / max(n_active - 1, 1))
    sats = [SatParams(prn=p, doppler_hz=-3000.0 + step * k,
                      doppler_rate_hz_s=5.0 if order == 3 else 0.0,
                      delay_chips=float(k * L // n_ch) + 37.0 + half,
                      cn0_dbhz=45.0)
            for k, p in enumerate(prns[:n_active])]
    gen_spec = dataclasses.replace(spec, code_rate_chips_s=rate,
                                   code_length_chips=L)
    x = generate_baseband(gen_spec, sats, {p: reps[p][0] for p in prns},
                          fs, n / fs + 1e-3, noise=True, seed=5)[:n]
    st = eng.init_state()
    for ch, s in enumerate(sats):
        st = eng.activate_channel(st, ch, ch, s.delay_chips / rate * fs,
                                  s.doppler_hz, 0, 0, doppler_step_hz=250.0)

    def make(n_samp, dev):
        return generate_on_card(gen_spec, sats, {p: reps[p][0] for p in prns},
                                fs, n_samp / fs + 1e-3, dev, seed=5)[:n_samp]

    return eng, st, torch.as_tensor(x.astype(np.complex64)), base, make


def _kf_diff(kb, got, want, what):
    """The KF kernel's outputs against the plain version's at the bars of
    tests/test_torch_kf.py: int rows and the carried int state exact;
    Doppler, code-frequency delta and rem code phase within 2e-2; rem
    carrier phase within 1e-4 2 pi (circular); CN0 and sigma2 at rtol
    1e-3; correlators within 1e-4 of max|corr| in the plain version's
    carrier frame: each epoch's taps turned by the difference of the two
    phase states at the epoch's start (the previous epoch's rem carrier
    phase, itself held to its bar above).  The KF's phase state is never
    wrapped (it grows by 2 pi f_D T an epoch, ~1,500 rad over two blocks
    at 3 kHz), so where two summation orders round an update to
    neighbouring float32 values the states differ by one unit of it,
    1.2e-4 rad there, and every later tap turns by that much; the raw
    difference is reported as `corr_raw`.  Every error is measured before
    any bar is checked, so a failure reports them all."""
    of, oi, fs_, is_ = (t.cpu().numpy() for t in got)
    wf, wi, wfs, wis = (t.numpy() for t in want)
    v = wi[:, kb.OI_VALID] != 0
    err = {"int_rows_equal": bool(np.array_equal(oi, wi)
                                  and np.array_equal(is_, wis)),
           "valid_epochs": int(v.sum())}
    for name, row in (("doppler", kb.O_DOPPLER), ("delta", kb.O_DELTA),
                      ("rem_code", kb.O_REM_CODE),
                      ("doppler_rate", kb.O_DOPPLER_RATE)):
        err[name] = float(np.abs(of[:, row] - wf[:, row])[v].max())
    for name, row in (("state_doppler", kb.R_X + 1),
                      ("state_delta", kb.R_DELTA)):
        err[name] = float(np.abs(fs_[row] - wfs[row]).max())
    c = slice(kb.O_CORR, kb.O_CORR + 6)
    err["corr_scale"] = float(np.abs(wf[:, c]).max())
    err["corr_raw"] = float(np.abs(of[:, c] - wf[:, c]).max())
    turn = np.zeros(of.shape[::2])                   # [E, C]
    turn[1:] = of[:-1, kb.O_REM_CARR] - wf[:-1, kb.O_REM_CARR]
    k, p = slice(kb.O_CORR, kb.O_CORR + 3), slice(kb.O_CORR + 3, kb.O_CORR + 6)
    got_c = (of[:, k] + 1j * of[:, p]) * np.exp(1j * turn)[:, None]
    want_c = wf[:, k] + 1j * wf[:, p]
    err["corr"] = float(max(np.abs(got_c.real - want_c.real).max(),
                            np.abs(got_c.imag - want_c.imag).max()))
    d = np.abs(of[:, kb.O_REM_CARR] - wf[:, kb.O_REM_CARR])[v]
    err["rem_carr"] = float(np.minimum(d, 2 * np.pi - d).max())
    for name, row in (("cn0", kb.O_CN0), ("sigma2", kb.O_SIGMA2)):
        g, w = of[:, row][v], wf[:, row][v]
        err[name] = float((np.abs(g - w) / np.maximum(np.abs(w), 1e-30)).max())
        err[name + "_ok"] = bool(np.all(np.abs(g - w)
                                        <= 1e-4 + 1e-3 * np.abs(w)))
    err["max_abs_err"] = max(err["corr"], err["doppler"], err["delta"],
                             err["rem_code"], err["rem_carr"])
    bad = [k for k, ok in (
        ("int rows", err["int_rows_equal"]), ("valid epochs", v.any()),
        ("doppler", err["doppler"] <= 2e-2), ("delta", err["delta"] <= 2e-2),
        ("rem_code", err["rem_code"] <= 2e-2),
        ("doppler_rate", err["doppler_rate"] <= 2e-2),
        ("state_doppler", err["state_doppler"] <= 2e-2),
        ("state_delta", err["state_delta"] <= 2e-2),
        ("corr", err["corr"] <= 1e-4 * err["corr_scale"]),
        ("rem_carr", err["rem_carr"] <= 1e-4 * 2 * np.pi),
        ("cn0", err["cn0_ok"]), ("sigma2", err["sigma2_ok"])) if not ok]
    if bad:
        raise AssertionError(f"KF kernel {what}: {bad} out of bounds: {err}")
    return err


def _kf_bound(kb, spec, n_samp, out_i):
    """Least time of one walk: the bytes it must move (the samples and the
    channels' code rows read once, the state read and written, the
    per-epoch rows written) against its operations on this run's data (the
    correlated samples of the valid epochs, KF_OPS_PER_SAMPLE each, and the
    scalar update of each valid epoch)."""
    C = spec.C
    v = out_i[:, kb.OI_VALID] != 0
    n_corr = int(np.minimum(out_i[:, kb.OI_CURLEN], spec.n_max)[v].sum())
    n_bytes = (n_samp * 8 + C * spec.code_len * 4
               + 2 * (kb.n_frows(spec.n_hist) + kb.N_IROWS) * C * 4
               + out_i.shape[0] * (kb.N_OROWS + kb.N_OIROWS) * C * 4)
    n_ops = KF_OPS_PER_SAMPLE * n_corr + OPS_PER_EPOCH_CHANNEL * int(v.sum())
    tb, to = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops,
            "correlated_samples": n_corr}


def _kf_segment(dev, kb, eng, st, base, make, n_active):
    """The launch the engine makes on a capture segment (KF_SEG_BLOCKS
    blocks, the scenario made on the card), timed with CUDA events as us
    per epoch; then the same launch through the KF_BLOCK_STAGES build
    (int rows held to the plain build's exactly), whose timeline of CTA 0
    splits each epoch in which its channel correlates into the barrier and
    m (from thread 0's start of the epoch to thread 32's m), the
    correlation (thread 32: the prefetch wait, its samples, its warp's
    sums), the reduction (the barrier, the prefetch issue and the sums
    over warps, to thread 0's reduced taps) and the update (thread 0), and
    gives the update's state-only part that runs beside the correlation;
    cycles become us by the stage launch's event time over the cycles its
    timeline spans.  The serial floor of one block: its epochs times one
    update's measured latency (both parts) and one barrier's."""
    from gnss_sdr_1_tpu_torch.ops import _build

    spec = eng.block_spec(base, KF_SEG_BLOCKS)
    n = KF_SEG_BLOCKS * base + spec.n_max
    x = make(n, dev)
    fst, ist = (t.to(dev) for t in eng.pack_state(st))
    codes = eng._codes.to(dev)
    E = KF_SEG_BLOCKS * spec.n_epochs
    ms = _time_cuda(lambda: kb.kf_block_cuda(spec, x, codes, fst, ist), 5)
    out = kb.kf_block_cuda(spec, x, codes, fst, ist)
    oi = out[1].cpu().numpy()
    n_valid = int((oi[:, kb.OI_VALID] != 0).sum())
    want = 0.9 * n_active * KF_SEG_BLOCKS * KF_BLOCK_MS * 1e-3 \
        / eng.cfg.code_period_s
    if not (bool(torch.isfinite(out[0]).all()) and n_valid >= want):
        raise AssertionError(f"KF segment: {n_valid} valid epochs (want "
                             f">= {want:.0f}) or non-finite outputs")
    t0 = time.perf_counter()
    _build.kf_stage_library()
    build_s = time.perf_counter() - t0
    stages = torch.zeros((E, kb.STAGE_POINTS), dtype=torch.int64,
                         device=dev)

    def staged():
        return kb.kf_block_cuda(spec, x, codes, fst, ist, stages=stages)

    s_ms = _time_cuda(staged, 3)
    s_out = staged()
    tl = stages.cpu().numpy().astype(np.float64)
    v = np.nonzero(tl[:-1, kb.TL_WAIT] > 0)[0]    # CTA 0's channel ran
    if not (np.array_equal(s_out[1].cpu().numpy(), oi) and len(v) > E // 2):
        raise AssertionError(f"KF stage build: int rows differ from the "
                             f"plain build's, or {len(v)} of {E} epochs in "
                             f"its timeline")
    us_per_cycle = s_ms * 1e3 / (tl[-1, kb.TL_UPD] - tl[0, kb.TL_START])
    spans = {
        "barrier_m": tl[v, kb.TL_M32] - tl[v, kb.TL_START],
        "correlation": tl[v, kb.TL_PART] - tl[v, kb.TL_M32],
        "reduction": tl[v, kb.TL_RED] - tl[v, kb.TL_PART],
        "update": tl[v, kb.TL_UPD] - tl[v, kb.TL_RED]}
    inner = {
        "prefetch_wait": tl[v, kb.TL_WAIT] - tl[v, kb.TL_M32],
        "samples": tl[v, kb.TL_SAMP] - tl[v, kb.TL_WAIT],
        "update_pre": tl[v, kb.TL_PRE] - tl[v, kb.TL_M0]}
    epoch = float((tl[v + 1, kb.TL_START] - tl[v, kb.TL_START]).mean())
    us = {k: float(d.mean()) * us_per_cycle for k, d in spans.items()}
    one = eng.block_spec(base, 1)
    return {"seg_blocks": KF_SEG_BLOCKS, "seg_epochs": E,
            "seg_ms": ms, "seg_us_per_epoch": ms * 1e3 / E,
            "seg_valid_epochs": n_valid,
            "seg_bound_ms": _kf_bound(kb, spec, n, oi)["bound_ms"],
            "stage_build_s": build_s, "stage_ms": s_ms,
            "stage_epochs": len(v), "stage_epoch_us": epoch * us_per_cycle,
            "stage_share": {k: float(d.mean()) / epoch
                            for k, d in spans.items()},
            "stage_us_per_epoch": us,
            # every span of every epoch in its order (thread 0's and 32's
            # stamps interleave as the epoch runs)
            "stage_ordered": bool(min(d.min() for d in spans.values())
                                  >= 0),
            **{f"{k}_us": float(d.mean()) * us_per_cycle
               for k, d in inner.items()},
            "prefetch_hits": int(tl[v, kb.TL_HIT].sum()),
            "stage_mhz": 1.0 / us_per_cycle,
            "serial_floor_ms": one.n_epochs * (
                us["update"] + us["barrier_m"]
                + float(inner["update_pre"].mean()) * us_per_cycle) * 1e-3}


def phase_kf_kernel(dev, kb):
    """The KF block kernel against kf_block_plain on the CPU at every shape
    of KF_CHECKS (two blocks a launch, so the rebase between blocks runs in
    the kernel), and timed at the shapes marked: device ms per one-block
    launch from the profiler, the plain version's on the card, the launch
    geometry (cluster size, threads per CTA, shared memory, prefetch); at
    the GPS shape also the engine's 25-block launch and the stage split
    (_kf_segment)."""
    rows = []
    for what, signal, fs, n_ch, n_act, order, bayes, timed in KF_CHECKS:
        eng, st, x, base, make = _kf_engine(signal, fs, n_ch, n_act, order,
                                            bayes, 2)
        spec = eng.block_spec(base, 2)
        fst, ist = eng.pack_state(st)
        want = kb.kf_block_plain(spec, x, eng._codes, fst, ist)
        card = [t.to(dev) for t in (x, eng._codes, fst, ist)]
        got = kb.kf_block_cuda(spec, *card)
        torch.cuda.synchronize()
        r = {"what": what, "signal": signal, "fs": fs, "C": n_ch,
             "active": n_act, "order": order, "bayes": bayes,
             "n_epochs": spec.n_epochs, "blocks": 2, "n_max": spec.n_max,
             "code_len": spec.code_len,
             **_kf_diff(kb, got, want, f"{what} order {order} bayes "
                                       f"{bayes}")}
        if timed:
            one = eng.block_spec(base, 1)
            geo = kb.launch_geometry(one)
            r.update(n_cta=geo.n_cta, threads=geo.threads, cpc=geo.cpc,
                     smem=geo.smem, prefetch=geo.prefetch)
            xs = card[0][: base + spec.n_max]

            def call():
                kb.kf_block_cuda(one, xs, *card[1:])

            r["ms"] = _device_ms(call, 20)
            r["ms_host"] = _time_cuda(call, 20)
            r["plain_ms"] = _time_cuda(
                lambda: kb.kf_block_plain(one, xs, *card[1:]), 2)
            oi = kb.kf_block_plain(one, x[: base + spec.n_max], eng._codes,
                                   fst, ist)[1].numpy()
            r.update(_kf_bound(kb, one, base + spec.n_max, oi))
            r["library_ms"] = None
            if what == "GPS":
                r.update(_kf_segment(dev, kb, eng, st, base, make, n_act))
        rows.append(r)
    return rows


# ---------------------------------------------------------------------------
# phase 2c: the gather DLL/PLL walk and the one-epoch multicorrelator
# against their plain versions
# ---------------------------------------------------------------------------


def _gather_sats(signal, n_active, dur):
    """The kernel checks' satellites of `signal` (phase 2's), for GPS the
    engine benchmark's 12 and, past 12, more from seed 51."""
    from gnss_sdr_1_tpu_torch.siggen import SatParams

    if signal == "1B":
        return _e1_sats(dur)
    if signal in ("L5", "5X", "B1", "B3"):
        return _sec_sats(signal, dur)
    if signal in ("1G", "2S"):
        return (_glo_sats if signal == "1G" else _l2c_sats)(dur)
    sats = _bench_sats(dur)
    rng = np.random.default_rng(51)
    sats += [SatParams(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),
                       delay_chips=float(rng.uniform(0, 1023)),
                       cn0_dbhz=44.0,
                       nav_bits=rng.choice([-1.0, 1.0],
                                           size=int(dur * 50) + 8))
             for p in range(13, 19)]
    return sats[:n_active]


def _gather_case(dev, signal, fs, n_ch, n_active, walk_ms=GATHER_WALK_MS):
    """A gather engine on the CPU with `n_active` channels activated at
    their satellites' truth on a seeded capture and tracked over a short
    head by the plain walk (the secondary-code signals then switched to the
    extended mode with the wipe on from their true, non-zero code index),
    and the inputs of the next `walk_ms` ms: (engine, spec, samples,
    codes, sec_rows, fst, ist, n_epochs), all on the CPU."""
    from gnss_sdr_1_tpu_torch.codes import tracking_replica
    from gnss_sdr_1_tpu_torch.constants import SIGNALS

    eng = _engine(torch.device("cpu"), fs, signal, "gather", n_ch)
    head = {"2S": 0.1, "1B": 0.052}.get(signal, 0.053)
    dur = head + walk_ms * 1e-3 + 3 * eng.cfg.code_period_s
    sats = _gather_sats(signal, n_active, dur + 0.01)
    if signal in ("1G", "2S"):
        x = generate_on_card(SIGNALS[signal], sats, {
            s.prn: tracking_replica(signal, s.prn)[0] for s in sats}, fs,
            dur, dev, seed=48).cpu()
    else:
        x = torch.as_tensor(_gen(
            sats, dur, f"gather_{signal}_{fs:.0f}_{n_active}_{dur:g}s_v1",
            fs, signal))
    st = _activate_all(eng, sats)
    span = int(fs * head)
    st, _ = eng.track_capture(x[: span + eng.cfg.epoch_samples_max], st,
                              span)
    if eng.chain_spec.sec_len > 1:
        n = eng.chain_spec.sec_len
        phases = st.epochs_in_track.numpy() % n
        if not (phases > 0).all() or not bool(st.active.all()):
            raise AssertionError(f"{signal} gather check: secondary phases "
                                 f"{phases}, active {st.active}")
        for ch, ph in enumerate(phases):
            st = eng.enable_extended(st, ch, (n - int(ph)) % n,
                                     sec_phase=int(ph))
    walk = int(fs * walk_ms * 1e-3)
    seg = x[span:]
    fst, ist = eng._pack_rows(st, walk)
    slot = st.prn_slot.long()
    return (eng, eng.gather_spec, seg, eng._codes[slot].contiguous(),
            eng._sec[slot].T.contiguous(), fst, ist,
            eng._check_capture(seg, walk))


def _gather_diff(tc, got, want, what):
    """The gather kernel's outputs against the plain version's at the bars
    of _kf_diff: int rows, the valid and active rows and the carried int
    state exact; Doppler, code-frequency delta and rem code phase within
    2e-2; rem carrier phase within 1e-4 2 pi (circular); CN0 at rtol 1e-3;
    correlators within 1e-4 of max|corr| in the plain version's carrier
    frame (each epoch's taps turned by the difference of the two entering
    rem carrier phases, themselves held to their bar; at a GLONASS slot's
    2.81 MHz a last-bit Doppler difference moves the phase by ~1e-3 rad an
    epoch), the raw difference reported as `corr_raw`.  Every error is
    measured before any bar is checked."""
    of, oi, oc, fs_, is_ = (t.cpu().numpy() for t in got)
    wf, wi, wc, wfs, wis = (t.numpy() for t in want)
    K = oc.shape[1] // 2
    v = wf[:, tc.O_VALID] > 0.5
    err = {"int_rows_equal": bool(
        np.array_equal(oi, wi) and np.array_equal(is_, wis)
        and np.array_equal(of[:, tc.O_VALID], wf[:, tc.O_VALID])
        and np.array_equal(of[:, tc.O_ACTIVE], wf[:, tc.O_ACTIVE])),
        "valid_epochs": int(v.sum())}
    for name, row in (("doppler", tc.O_DOPPLER), ("delta", tc.O_DELTA),
                      ("rem_code", tc.O_REM_CODE)):
        err[name] = float(np.abs(of[:, row] - wf[:, row])[v].max())
    for name, row in (("state_doppler", tc.F_DOPPLER),
                      ("state_delta", tc.F_DELTA)):
        err[name] = float(np.abs(fs_[row] - wfs[row]).max())
    err["corr_scale"] = float(np.abs(wc).max())
    err["corr_raw"] = float(np.abs(oc - wc).max())
    turn = np.zeros(of.shape[::2])                   # [E, C]
    turn[1:] = of[:-1, tc.O_REM_CARR] - wf[:-1, tc.O_REM_CARR]
    got_c = (oc[:, :K] + 1j * oc[:, K:]) * np.exp(1j * turn)[:, None]
    want_c = wc[:, :K] + 1j * wc[:, K:]
    err["corr"] = float(max(np.abs(got_c.real - want_c.real).max(),
                            np.abs(got_c.imag - want_c.imag).max()))
    d = np.abs(of[:, tc.O_REM_CARR] - wf[:, tc.O_REM_CARR])[v]
    err["rem_carr"] = float(np.minimum(d, 2 * np.pi - d).max())
    g, w = of[:, tc.O_CN0][v], wf[:, tc.O_CN0][v]
    err["cn0"] = float((np.abs(g - w) / np.maximum(np.abs(w), 1e-30)).max())
    err["cn0_ok"] = bool(np.all(np.abs(g - w) <= 1e-4 + 1e-3 * np.abs(w)))
    err["max_abs_err"] = max(err["corr"], err["doppler"], err["delta"],
                             err["rem_code"], err["rem_carr"])
    bad = [k for k, ok in (
        ("int rows", err["int_rows_equal"]), ("valid epochs", v.any()),
        ("doppler", err["doppler"] <= 2e-2), ("delta", err["delta"] <= 2e-2),
        ("rem_code", err["rem_code"] <= 2e-2),
        ("state_doppler", err["state_doppler"] <= 2e-2),
        ("state_delta", err["state_delta"] <= 2e-2),
        ("corr", err["corr"] <= 1e-4 * err["corr_scale"]),
        ("rem_carr", err["rem_carr"] <= 1e-4 * 2 * np.pi),
        ("cn0", err["cn0_ok"])) if not ok]
    if bad:
        raise AssertionError(f"gather kernel {what}: {bad} out of bounds: "
                             f"{err}")
    return err


def _samples_read(tc, n_max, out_f, out_i):
    """The distinct samples a walk's valid epochs correlate: the union over
    channels and epochs of [start, start + min(cur_len, n_max)) (out_i's
    rows), from the plain version's outputs of the same walk."""
    v = out_f[:, tc.O_VALID] > 0.5
    lo = out_i[:, 0][v].astype(np.int64)
    if lo.size == 0:
        return 0
    hi = lo + np.minimum(out_i[:, 1][v], n_max)
    base = int(lo.min())
    edge = np.zeros(int(hi.max()) - base + 1, np.int64)
    np.add.at(edge, lo - base, 1)
    np.add.at(edge, hi - base, -1)
    return int((np.cumsum(edge)[:-1] > 0).sum())


def _gather_bound(tc, spec, out_f, out_i):
    """Least time of one walk: the bytes it must move (the samples its
    valid epochs correlate and the channels' code rows read once, the
    state read and written, the per-epoch rows written) against its
    operations on this run's data (the correlated samples of the valid
    epochs, GATHER_OPS_PER_SAMPLE[K] each, and one closure of
    OPS_PER_EPOCH_CHANNEL per valid epoch)."""
    C, K = spec.C, spec.K
    v = out_f[:, tc.O_VALID] > 0.5
    n_corr = int(np.minimum(out_i[:, 1], spec.n_max)[v].sum())
    n_samp = _samples_read(tc, spec.n_max, out_f, out_i)
    n_bytes = (n_samp * 8 + C * spec.code_len * 4
               + 2 * (tc.n_frows(K) + tc.N_IROWS) * C * 4
               + out_f.shape[0] * (tc.N_OROWS + 2 + 2 * K) * C * 4)
    n_ops = GATHER_OPS_PER_SAMPLE[K] * n_corr \
        + OPS_PER_EPOCH_CHANNEL * int(v.sum())
    tb, to = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops,
            "samples_read": n_samp, "correlated_samples": n_corr}


def _gather_instances(dev, gb, tc, bases, g):
    """Each of the 16 template instances <K, ORDER, SEC_DATA, HAS_SEC> that
    gather_kernel_for (csrc/gather_block.cu) can return, launched on the
    GPS (K=3) and E1B (K=5) cases against gather_block_plain on the CPU
    (_gather_diff's bars); ORDER=2 takes the order-2 loop coefficients with
    the integrator seeded from the Doppler; HAS_SEC a random 20-chip code
    with the wipe on in every other channel from a non-zero index; SEC_DATA
    switches the Costas discriminator."""
    import dataclasses

    from gnss_sdr_1_tpu_torch.track.loop_filter import fll_pll_coefficients

    w2 = fll_pll_coefficients(35.0, 25.0, 2)
    n2 = fll_pll_coefficients(8.0, 12.0, 2)
    coef = lambda c: (c.w0p, c.w0p2, c.w0p3, c.w0f, c.w0f2, c.a2, c.a3,
                      c.b3)                                     # noqa: E731
    rows = []
    for K, (spec0, x, codes, fst0, ist0, n_ep) in sorted(bases.items()):
        C = spec0.C
        for order in (2, 3):
            for sec_data in (False, True):
                for has_sec in (False, True):
                    loop = dataclasses.replace(spec0.loop, sec_data=sec_data)
                    fst, ist = fst0.clone(), ist0.clone()
                    if order == 2:
                        loop = dataclasses.replace(
                            loop, order=2, wide=coef(w2), narrow=coef(n2))
                        fst[tc.F_CARR_W] = fst[tc.F_DOPPLER]
                        fst[tc.F_CARR_X] = 0.0
                    if has_sec:
                        sec = torch.where(torch.rand((20, C), generator=g)
                                          < 0.5, -1.0, 1.0).float()
                        ist[tc.I_SEC_ON] = (torch.arange(C) % 2 == 0).to(
                            torch.int32)
                        ist[tc.I_SEC_IDX] = (torch.arange(C, dtype=torch.int32)
                                             * 7 + 3) % 20
                    else:
                        sec = torch.ones((1, C), dtype=torch.float32)
                        ist[tc.I_SEC_ON] = 0
                        ist[tc.I_SEC_IDX] = 0
                    loop = dataclasses.replace(loop, sec_len=sec.shape[0])
                    spec = dataclasses.replace(spec0, loop=loop)
                    name = (f"<{K},{order},{str(sec_data).lower()},"
                            f"{str(has_sec).lower()}>")
                    args = (x, codes, sec.contiguous(), fst, ist)
                    before = gb.launches
                    got = gb.gather_block(spec, *(t.to(dev) for t in args),
                                          n_ep)
                    torch.cuda.synchronize()
                    if gb.launches != before + 1:
                        raise AssertionError(f"{name}: the gather wrapper "
                                             f"did not launch")
                    want = gb.gather_block_plain(spec, *args, n_ep)
                    err = _gather_diff(tc, got, want, name)
                    rows.append({"instance": name,
                                 "err": err["max_abs_err"],
                                 "valid_epochs": err["valid_epochs"]})
    if len({r["instance"] for r in rows}) != 16:
        raise AssertionError(f"{len(rows)} gather instances checked")
    return rows


def _gather_segment(dev, gb, tc, eng, case):
    """The launch the receiver makes on a 1 s segment of the GPS shape
    (1,000 epochs of 12 channels, the capture made on the card, channels
    activated at the truth), timed with CUDA events: us per epoch, and its
    bound; then the same launch through the GATHER_BLOCK_STAGES build (int
    rows held to the plain build's exactly), whose timeline of CTA 0 gives
    the stage split of an epoch and the serial floor of a 40 ms block
    (ops/gather_block.py stage_split)."""
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA

    seg_s = 1.0
    sats = _gather_sats("1C", eng.cfg.n_channels, seg_s + 0.05)
    x = generate_on_card(GPS_L1_CA, sats, {s.prn: gps_l1ca_code(s.prn)
                                           for s in sats}, FS, seg_s + 0.01,
                         dev, seed=52)
    st = _activate_all(eng, sats)
    span = int(FS * seg_s)
    fst, ist = eng._pack_rows(st, span)
    slot = st.prn_slot.long()
    args = [x, eng._codes[slot].contiguous(), eng._sec[slot].T.contiguous(),
            fst, ist]
    card = [t.to(dev) for t in args]
    n_ep = eng._check_capture(x, span)
    ms = _time_cuda(lambda: gb.gather_block_cuda(case[1], *card, n_ep), 3)
    out = gb.gather_block_cuda(case[1], *card, n_ep)
    of, oi = out[0].cpu().numpy(), out[1].cpu().numpy()
    n_valid = int((of[:, tc.O_VALID] > 0.5).sum())
    if not (bool(torch.isfinite(out[0]).all()) and n_valid >= 0.95 * 12000):
        raise AssertionError(f"gather segment: {n_valid} valid epochs or "
                             f"non-finite outputs")
    stages = torch.zeros((n_ep, gb.STAGE_POINTS), dtype=torch.int64,
                         device=dev)

    def staged():
        return gb.gather_block_cuda(case[1], *card, n_ep, stages=stages)

    s_ms = _time_cuda(staged, 3)
    s_out = staged()
    if not (np.array_equal(s_out[1].cpu().numpy(), oi)
            and torch.equal(s_out[0][:, tc.O_VALID], out[0][:, tc.O_VALID])):
        raise AssertionError("gather stage build: int rows differ from the "
                             "plain build's")
    split = gb.stage_split(stages.cpu().numpy(), s_ms,
                           eng._check_capture(x, int(FS * 0.04)))
    if not (split["ordered"] and split["epochs"] > n_ep // 2):
        raise AssertionError(f"gather stage timeline out of order or short: "
                             f"{split}")
    return {"seg_epochs": n_ep, "seg_valid_epochs": n_valid, "seg_ms": ms,
            "seg_us_per_epoch": ms * 1e3 / n_ep,
            "seg_bound_ms": _gather_bound(tc, case[1], of, oi)["bound_ms"],
            "stage_ms": s_ms, "stages": split,
            "serial_floor_ms": split["serial_floor_ms"]}


def _mc_bound(K, n, L):
    """The one-epoch multicorrelator's least time for n samples: bytes (the
    samples and the code row read, the taps written) against operations
    (GATHER_OPS_PER_SAMPLE a sample)."""
    n_bytes = n * 8 + L * 4 + K * 8
    tb = n_bytes / PEAK_BYTES_S * 1e3
    to = GATHER_OPS_PER_SAMPLE[K] * n / PEAK_F32_S * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def _host_us(fn, n=300):
    """Host time per call of n back-to-back calls (the launches queue; the
    card is drained after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _mc_grid_case(g, K, C, order):
    """A synthetic epoch of C channels for the instance grid: K = 3 at the
    2c shape (4,094 samples, the 1,023-chip code), K = 5 at E1's 4 ms at
    4.092 Msps (16,368 samples, 4,092 chips: clusters of 16 CTAs); every
    n_valid short of N, channel 0's phase near 1e5 rad, the rate 3e-9
    rad/sample^2 at order 3 and 0 at order 2."""
    N, L = (4094, 1023) if K == 3 else (16368, 4092)
    x = torch.complex(torch.randn(C, N, generator=g),
                      torch.randn(C, N, generator=g)) * 30.0
    codes = torch.where(torch.rand(C, L, generator=g) < 0.5, -1.0, 1.0)
    shifts = torch.tensor((-0.5, 0.0, 0.5) if K == 3
                          else (-1.0, -0.5, 0.0, 0.5, 1.0))
    step = (L / N) * (1 + 1e-6 * (2 * torch.rand(C, generator=g) - 1))
    rem = torch.rand(C, generator=g) * 1.2 - 0.3
    cp = torch.rand(C, generator=g) * 6.2
    cp[0] += 1e5
    cs = (2 * torch.rand(C, generator=g) - 1) * 5e-3
    cr = torch.full((C,), 3e-9 if order == 3 else 0.0)
    nv = N - torch.randint(1, 60, (C,), generator=g, dtype=torch.int32)
    return x, codes, shifts, (step, rem, cp, cs, cr, nv)


def _mc_check_one(dev, mc, what, x, codes, shifts, args):
    """multicorrelate_cuda with the per-channel arguments as tensors on the
    card (by pointer) and as host arrays (by value; C <= MC_MAX_C) against
    the plain multicorrelate on the CPU within 1e-4 of max|corr|, the two
    transports bit for bit; returns (the row, the card's taps, the card's
    inputs)."""
    want = mc.multicorrelate(x, codes, shifts, *args[:5], n_valid=args[5])
    xd, cd = x.to(dev), codes.to(dev)
    on_card = [a.to(dev) for a in args]
    before = mc.launches
    got = mc.correlate(xd, cd, shifts, *on_card)
    by_value = mc.multicorrelate_cuda(xd, cd, shifts,
                                      *(a.numpy() for a in args))
    torch.cuda.synchronize()
    if mc.launches != before + 2:
        raise AssertionError("correlate did not launch the kernel")
    if not torch.equal(got, by_value):
        raise AssertionError(f"multicorrelate {what}: the taps by value "
                             f"differ from the taps by pointer")
    d = float((got.cpu() - want).abs().max())
    scale = float(want.abs().max())
    if not d <= 1e-4 * scale:
        raise AssertionError(f"multicorrelate {what}: |diff| {d:.3e} > "
                             f"1e-4 x {scale:.3e}")
    C, N = x.shape
    G, S = mc.mc_geometry(N)
    return ({"what": what, "K": len(shifts), "C": C, "N": N,
             "n_valid": [int(v) for v in args[5][:3]], "G": G, "slice": S,
             "max_abs_err": d, "scale": scale}, got, (xd, cd, on_card))


def _mc_timed(dev, mc, x, code, shifts, args):
    """One channel's launch (Python numbers by value) timed: the host time
    per call and CUDA events per call (before any profiling), the kernel's
    device time by its name (the mean over the trace's events), any other
    kernel or copy in the trace, the empty kernel of the same geometry
    (its device time and host time), the plain version on the card, the
    bound."""
    def call():
        mc.multicorrelate_cuda(x, code, shifts, *args)

    def empty():
        mc.multicorrelate_empty(x, code, shifts, args[5])

    n = 200
    # the host times first: a profiler run before them slows the host
    host = {"host_us": _host_us(call), "events_ms": _time_cuda(call, n),
            "empty_host_us": _host_us(empty)}
    ms, events = _event_ms(call, n, "multicorrelate_kernel")
    kernels = _by_name(events, n)
    others = {k: v for k, v in kernels.items()
              if "multicorrelate_kernel" not in k}
    nv = x.shape[-1] if args[5] is None else int(args[5])
    return {"ms": ms,
            "kernel": next(k for k in kernels if k not in others),
            "other_kernels": others,
            "copies": _by_name(events, n, "gpu_memcpy"), **host,
            "empty_ms": _event_ms(empty, n, "mc_empty_kernel")[0],
            "plain_ms": _time_cuda(
                lambda: mc.multicorrelate(x, code, shifts, *args[:5],
                                          n_valid=args[5]), 10),
            "library_ms": None,
            **_mc_bound(len(shifts), nv, code.shape[-1])}


def _mc_stages(dev, mc, x, code, shifts, args):
    """The MC_STAGES build at one channel's shape: the timeline of a launch
    in the wrapper's geometry (the spans of each CTA in cycles: the copy's
    issue, the code packing, the wait for the copy, the correlation, the
    CTA's and the cluster's reductions), and thread 0's cycles a sample
    with one CTA for the channel (16 samples a thread at 4,094) under each
    probe (nothing left out, the sine and cosine, the code indices, both,
    the double-precision range reduction)."""
    G, _ = mc.mc_geometry(x.shape[-1])

    def run(geometry=None, probe=0):
        return mc.multicorrelate_stages(x, code, shifts, *args,
                                        geometry=geometry, probe=probe)

    outs = [run()[0] for _ in range(MC_REPEATS)]
    wants = [mc.multicorrelate_cuda(x, code, shifts, *args)
             for _ in range(MC_REPEATS)]
    torch.cuda.synchronize()
    if not all(torch.equal(o, outs[0]) for o in outs) \
            or not all(torch.equal(w, wants[0]) for w in wants):
        raise AssertionError("a launch's taps differ from the same "
                             "launch's before")
    d = float((outs[0] - wants[0]).abs().max())
    if not d <= 1e-4 * float(wants[0].abs().max()):
        raise AssertionError(f"the MC_STAGES build's taps differ by {d:.3e}")
    out, tl = run()
    ms = _event_ms(run, 50, "multicorrelate_kernel")[0]
    split = mc.stage_split(tl.cpu().numpy(), ms)
    one = (1, x.shape[-1])
    probes = {}
    for name, mask in (("full", 0), ("no_sincos", mc.PROBE_SINCOS),
                       ("no_taps", mc.PROBE_TAPS),
                       ("neither", mc.PROBE_SINCOS | mc.PROBE_TAPS),
                       ("f32_reduction", mc.PROBE_F32)):
        run(one, mask)
        _, tl1 = run(one, mask)
        torch.cuda.synchronize()
        r = mc.stage_split(tl1.cpu().numpy())
        probes[name] = {"cycles_per_sample": r["cycles_per_sample"],
                        "samples_thread0": r["samples_thread0"],
                        "correlation_cycles": r["cycles"]["correlation"]}
    return {"G": G, "ms": ms, "split": split, "probes": probes,
            "repeats": MC_REPEATS, "stage_vs_plain_build_diff": d}


def _mc_checks(dev, mc, cases):
    """The one-epoch multicorrelator on the card: multicorrelate_cuda
    against the plain multicorrelate on the CPU within 1e-4 of max|corr|
    on one epoch of each real case's channels (their first windows, K = 3
    at the GPS shape, 5 at the E1B shape) and of its first channel alone
    (C = 1, the TCP connector's call), and on the four instances (K 3 and
    5, orders 2 and 3) at C = 1, 12 and 20 (_mc_grid_case), each by
    pointer and by value, bit for bit alike; the order-3 instance at a zero
    rate (a rate tensor on the card) bit for bit the order-2 instance (the
    rate 0.0 by value); then timed at C = 1, K = 3 (_mc_timed) at the GPS
    window (4,094 samples) and at phase 27's call (2,046), and through the
    MC_STAGES build (_mc_stages)."""
    from gnss_sdr_1_tpu_torch.ops import gather_block as gb
    from gnss_sdr_1_tpu_torch.ops import track_chain as tc

    rows = []
    for what, (eng, spec, x, codes, sec, fst, ist, n_ep) in cases.items():
        m, off = gb.window_offsets(spec, ist, x.shape[0])
        segs = x[(m + off).long()[:, None] + torch.arange(spec.n_max)]
        step, rem, cp, cs = gb.epoch_params(spec, fst)
        shifts = torch.tensor(spec.shifts)
        n_valid = ist[tc.I_CURLEN]
        for C in (spec.C, 1):
            args = (step[:C], rem[:C], cp[:C], cs[:C], torch.zeros(C),
                    n_valid[:C])
            r, _, card = _mc_check_one(dev, mc, what, segs[:C].contiguous(),
                                       codes[:C].contiguous(), shifts, args)
            if what == "GPS" and C == 1:
                # the TCP connector's call: Python numbers, the taps' offsets
                # a tuple
                xd, cd, on_card = card
                host = tuple(float(a[0]) for a in args[:5]) + (
                    int(args[5][0]),)
                taps = tuple(float(v) for v in shifts)
                r.update(_mc_timed(dev, mc, xd[0], cd[0], taps, host))
                r["stages"] = _mc_stages(dev, mc, xd[0], cd[0], taps, host)
                # phase 27's epoch: 2,046 samples of the same window
                r["tcp_shape"] = _mc_timed(dev, mc, xd[0, :2046], cd[0],
                                           taps, host[:5] + (None,))
            rows.append(r)
    g = torch.Generator().manual_seed(13)
    for K in (3, 5):
        for order in (2, 3):
            for C in MC_CHECK_C:
                x, codes, shifts, args = _mc_grid_case(g, K, C, order)
                r, got, (xd, cd, on_card) = _mc_check_one(
                    dev, mc, f"instance K={K} order {order}", x, codes,
                    shifts, args)
                r["order"] = order
                if C == 1:
                    # the samples from an odd sample: the copy's head
                    pad = torch.zeros(1, dtype=xd.dtype, device=dev)
                    odd = mc.multicorrelate_cuda(
                        torch.cat([pad, xd[0]])[1:], cd[0], shifts,
                        *on_card)
                    torch.cuda.synchronize()
                    if not torch.equal(odd, got[0]):
                        raise AssertionError(f"multicorrelate K={K}: the "
                                             f"taps from an odd start differ")
                if order == 2:
                    rate = torch.zeros(C, device=dev)
                    o3 = mc.multicorrelate_cuda(xd, cd, shifts, *on_card[:4],
                                                rate, on_card[5])
                    torch.cuda.synchronize()
                    if not torch.equal(o3, got):
                        raise AssertionError(
                            f"multicorrelate K={K} C={C}: the order-3 "
                            f"instance at a zero rate is not order 2's")
                    r["order3_at_zero_rate_equal"] = True
                rows.append(r)
    return rows


def phase_gather_kernel(dev, gb, mc):
    """The gather walk against gather_block_plain on the CPU at every shape
    of GATHER_CHECKS (two 40 ms blocks a launch), timed at the shapes
    marked (device ms per one-block launch from the profiler, the plain
    version's on the card, the bound, the launch geometry); the 16
    template instances on the GPS and E1B cases; at the GPS shape the
    receiver's 1 s segment launch in us per epoch; then the one-epoch
    multicorrelator (_mc_checks)."""
    from gnss_sdr_1_tpu_torch.ops import track_chain as tc

    rows, bases, mc_cases = [], {}, {}
    g = torch.Generator().manual_seed(9)
    for what, signal, fs, n_ch, n_act, timed in GATHER_CHECKS:
        case = _gather_case(dev, signal, fs, n_ch, n_act)
        eng, spec, x, codes, sec, fst, ist, n_ep = case
        args = (x, codes, sec, fst, ist)
        want = gb.gather_block_plain(spec, *args, n_ep)
        card = [t.to(dev) for t in args]
        got = gb.gather_block_cuda(spec, *card, n_ep)
        torch.cuda.synchronize()
        geo = gb.launch_geometry(spec)
        r = {"what": what, "signal": signal, "fs": fs, "C": n_ch,
             "active": n_act, "K": spec.K, "order": spec.loop.order,
             "sec_len": spec.loop.sec_len, "n_epochs": n_ep,
             "n_max": spec.n_max, "code_len": spec.code_len,
             "carr_offsets_hz": [round(float(v)) for v in
                                 fst[tc.F_CARR_OFF]],
             "n_cta": geo.n_cta, "threads": geo.threads, "cpc": geo.cpc,
             "smem": geo.smem, "prefetch": geo.prefetch,
             **_gather_diff(tc, got, want, what)}
        if timed:
            blk = eng._check_capture(x, int(fs * GATHER_WALK_MS * 5e-4))

            def call():
                gb.gather_block_cuda(spec, *card, blk)

            # CUDA events time the launch: torch.profiler loses this
            # kernel now and then (at one shape in one run, at every shape
            # in another); its device time beside it where the trace holds
            # it
            r["block_epochs"] = blk
            r["ms"] = _time_cuda(call, 10)
            try:
                r["ms_profiler"] = _device_ms(call, 10)
            except NoKernelEvent:
                r["ms_profiler"] = None
            r["plain_ms"] = _time_cuda(
                lambda: gb.gather_block_plain(spec, *card, blk), 1)
            ob = gb.gather_block_plain(spec, *args, blk)
            r.update(_gather_bound(tc, spec, ob[0].numpy(), ob[1].numpy()))
            r["library_ms"] = None
            if what == "GPS":
                r.update(_gather_segment(dev, gb, tc, eng, case))
        if what in ("GPS", "E1B"):
            bases[spec.K] = (spec, x, codes, fst, ist, n_ep)
            mc_cases[what] = case
        rows.append(r)
    inst = _gather_instances(dev, gb, tc, bases, g)
    return rows, inst, _mc_checks(dev, mc, mc_cases)


# ---------------------------------------------------------------------------
# phase 2d: the symbol-grid reduction
# ---------------------------------------------------------------------------

# (what, cap, C, N, K, prompt, {channel: first invalid epoch}): the GPS
# receiver's 1 s segment at 8 and 12 channels, a cap not a multiple of N
# with channels that drop, never track or track one epoch, and the E1B
# receiver's 1 s segment at 4 and 8 channels (N = 1, K = 5 VEML taps)
SYMBOL_CASES = (("GPS C=8", 1008, 8, 20, 3, 1, {}),
                ("GPS C=12", 1004, 12, 20, 3, 1, {}),
                ("GPS drops", 1006, 12, 20, 3, 1, {2: 500, 5: 0, 7: 1}),
                ("E1B C=4", 252, 4, 1, 5, 2, {1: 100, 3: 0}),
                ("E1B C=8", 252, 8, 1, 5, 2, {}))


def _symbol_rows(dev, cap, C, K, drops, g):
    """Per-epoch rows as a walk leaves them, random where the reduction
    reads (negative correlators on invalid epochs, so -0.0 products
    occur; rem_code on a quarter-sample grid in half the channels, so its
    steps hold exact halves), on the card; the channels' entering
    rem_code."""
    from gnss_sdr_1_tpu_torch.ops import track_chain as tc

    f32 = torch.float32
    out_f = torch.randn((cap, tc.N_OROWS, C), generator=g) * 100
    valid = torch.ones((cap, C))
    active = torch.ones((cap, C))
    for c, e in drops.items():
        valid[e:, c] = 0.0
        active[max(e - 1, 0):, c] = 0.0
    out_f[:, tc.O_VALID] = valid
    out_f[:, tc.O_ACTIVE] = active
    rem = torch.rand((cap, C), generator=g) * 6 - 3
    grid = torch.randint(-12, 12, (cap, C), generator=g).to(f32) * 0.25
    rem[:, ::2] = grid[:, ::2]
    out_f[:, tc.O_REM_CODE] = rem
    out_i = torch.randint(-(1 << 20), 1 << 20, (cap, 2, C), generator=g,
                          dtype=torch.int32)
    out_corr = torch.randn((cap, 2 * K, C), generator=g) * 1000
    entering = torch.randint(-8, 8, (C,), generator=g).to(f32) * 0.25
    return [t.to(dev) for t in (out_f, out_i, out_corr, entering)]


def _symbol_bits_equal(got: dict, want: dict, what):
    """Every field of the kernel's SymbolOutputs bit for bit the plain
    version's (floats as int32, so zeros' signs count)."""
    for f, w in want.items():
        a, b = np.asarray(got[f]), w.cpu().numpy()
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
                a.view(np.int32) if a.dtype == np.float32 else a,
                b.view(np.int32) if b.dtype == np.float32 else b):
            raise AssertionError(f"symbol_slots {what}: {f} differs from "
                                 f"symbol_slots_plain")


def _symbol_bound(cap, C, S):
    """Bytes once at the card's HBM rate: the prompt I, Q and valid flag
    of every epoch, each slot's picks (start, rem_code and the one before,
    rem_carr, Doppler, C/N0, delta), the active flags and entering
    rem_code read; the packed buffer written."""
    words = 3 * cap * C + 7 * S * C + 2 * C + 9 * S * C + 2 * C
    return 4 * words / PEAK_BYTES_S * 1e3


def phase_symbol_kernel(dev):
    """Phase 2d: the symbol-grid kernel against symbol_slots_plain on the
    card, bit for bit, at SYMBOL_CASES through both walks' libraries, one
    launch a call, the channels' offsets spread over 1..N; timed at the
    GPS and E1B receivers' shapes (device time by name from the profiler,
    back-to-back calls by CUDA events, the plain version as the engine
    ran it before the kernel: its offsets' upload and sync included)."""
    from gnss_sdr_1_tpu_torch.ops import _build
    from gnss_sdr_1_tpu_torch.ops import symbol_slots as ss

    g = torch.Generator(device="cpu").manual_seed(19)
    rows = []
    for what, cap, C, N, K, prompt, drops in SYMBOL_CASES:
        t = _symbol_rows(dev, cap, C, K, drops, g)
        off = (np.arange(C) * 7 + 3) % N + 1
        want = ss.symbol_slots_plain(*t, off, N, prompt)
        S = ss.n_slots(cap, N)
        for lib in (_build.library(), _build.gather_library()):
            before = ss.launches
            buf = ss.symbol_slots_cuda(*t, off, N, prompt, lib)
            if ss.launches != before + 1:
                raise AssertionError(f"symbol_slots {what}: "
                                     f"{ss.launches - before} launches")
            _symbol_bits_equal(ss.unpack(buf.cpu().numpy(), S, C), want,
                               what)
        r = {"what": what, "cap": cap, "C": C, "N": N, "S": S, "K": K,
             "drops": len(drops), "bound_ms": _symbol_bound(cap, C, S),
             "bound_by": "bytes"}
        if what in ("GPS C=8", "E1B C=4"):
            lib = _build.library()

            def call():
                ss.symbol_slots_cuda(*t, off, N, prompt, lib)

            r["ms"], _ = _event_ms(call, 50, "symbol_slots")
            r["events_ms"] = _time_cuda(call, 500)
            r["plain_ms"] = _time_cuda(
                lambda: ss.symbol_slots_plain(*t, off, N, prompt), 20)
        rows.append(r)
    return rows


# the stream front end's kernel cases: the NSR cell's segment (1 s at 2.56
# Msps and the epoch tail, 65 taps, D = 8, a real 2-bit IF) and the GPS
# ishort cell's (1 s at 2 Msps and the tail, one tap, D = 2)
XLATE_CASES = (("NSR cell", "nsr", 20.48e6, 5499998.47412109, 8,
                2_560_000, 2_562_562),
               ("GPS ishort cell", "ishort", 4.0e6, 0.0, 2, 2_000_000,
                2_002_002))


def phase_xlate_kernel(dev):
    """Phase 2e: the stream front end's kernel against xlate_fir_plain on
    the CPU at the cells' segment shapes, as two segments of a stream
    from an absolute output ~10 h in (within 2 float32 ulps of each
    output's magnitude: the cosine and sine may round to the other
    float32; the sums are the same operations), the second segment bit
    for bit the same outputs of one launch over both; timed (device time
    by name from the profiler, back-to-back calls by CUDA events, the
    plain version on the card) beside the bound of
    benchmark/gnssbench/roofline_front_end.py's count."""
    from gnss_sdr_1_tpu_torch.ops import xlate_fir as xf
    from gnss_sdr_1_tpu_torch.runtime.config import FrontEnd
    from gnss_sdr_1_tpu_torch.runtime.stream import StreamFrontEnd

    rows = []
    rng = np.random.default_rng(23)
    cpu = torch.device("cpu")
    for what, fmt, fs, if_hz, decim, span, n_out in XLATE_CASES:
        fe = FrontEnd(fs, fs / decim, if_hz,
                      "Freq_Xlating_Fir_Filter" if if_hz else "Pass_Through",
                      "Direct_Resampler")
        n_src = (span + n_out) * decim
        raw = (rng.integers(0, 256, n_src // 4, dtype=np.uint8)
               if fmt == "nsr" else
               rng.integers(-3000, 3000, 2 * n_src).astype(np.int16))
        outs = {}
        for where in (dev, cpu):
            sfe = StreamFrontEnd(fe, fmt, where)
            sfe.next_out = 92_160_000_000
            segs = []
            for k in range(2):
                a = sfe.items(k * span * decim)
                b = sfe.items((k * span + n_out) * decim)
                before = xf.launches
                segs.append(sfe.condition(torch.from_numpy(raw[a:b]).to(
                    where), n_out, span, 0.61).cpu().numpy())
                if xf.launches != before + (where == dev):
                    raise AssertionError(f"xlate_fir {what}: "
                                         f"{xf.launches - before} launches")
            outs[where.type] = segs
        one = StreamFrontEnd(fe, fmt, dev)
        one.next_out = 92_160_000_000
        whole = one.condition(torch.from_numpy(raw).to(dev), span + n_out,
                              span + n_out, 0.61).cpu().numpy()
        errs, equal = [], 0
        for g, w in zip(outs["cuda"], outs["cpu"]):
            rms = float(np.sqrt(np.mean(np.abs(w) ** 2)))
            tol = 2 * np.spacing(np.abs(w).astype(np.float32)) + 1e-7 * rms
            if not np.all(np.abs(g - w) <= tol):
                raise AssertionError(f"xlate_fir {what}: max |diff| "
                                     f"{np.abs(g - w).max():.3e}")
            errs.append(float(np.abs(g - w).max()))
            equal += int((g.view(np.uint64) == w.view(np.uint64)).sum())
        if not np.array_equal(outs["cuda"][1].view(np.uint32),
                              whole[span:].view(np.uint32)):
            raise AssertionError(f"xlate_fir {what}: the seam differs")
        raw_dev = torch.from_numpy(raw[:sfe.items(n_out * decim)]).to(dev)
        sfe = StreamFrontEnd(fe, fmt, dev)

        def call():
            sfe.reset()
            sfe.condition(raw_dev, n_out, span, 0.61)

        def plain():
            xf.xlate_fir_plain(None, raw_dev, fmt, sfe.taps, decim,
                               sfe.n_hist, n_out, 0, sfe.dphase, 0.61)

        ms, _ = _event_ms(call, 20, "xlate_fir_kernel")
        bound, by = _xlate_bound(fmt, n_out, sfe.n_taps, raw_dev)
        rows.append({"what": what, "fmt": fmt, "outputs": n_out,
                     "taps": sfe.n_taps, "decim": decim,
                     "err": max(errs), "rms": rms,
                     "bits_equal": equal / (2 * n_out), "ms": ms,
                     "events_ms": _time_cuda(call, 100),
                     "plain_ms": _time_cuda(plain, 3),
                     "bound_ms": bound * 1e3, "bound_by": by})
    return rows


def _xlate_bound(fmt, n_out, taps, raw_dev):
    """The least time of a segment's conditioning (the count of
    benchmark/gnssbench/roofline_front_end.py)."""
    per_tap = 4 if fmt == "nsr" else 8
    ops = n_out * (taps * per_tap + 24)
    nbytes = raw_dev.numel() * raw_dev.element_size() + n_out * 8 + taps * 8
    t_ops, t_bytes = ops / PEAK_F32_S, nbytes / PEAK_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# phase 35: process_stream through the conf's front end (conf, raw format,
# source rate, the seconds streamed); phase 5's satellites at STREAM_FE_CN0
# (the confs pull channels in from acquisition, and a channel that loses
# lock in its first second is acquired again a segment later: at least
# STREAM_FE_MIN_SYNCED channels end bit-synced)
STREAM_FE_RUNS = (("gps_l1_nsr.conf", "nsr", 20.48e6, 8.0),
                  ("gps_l1_ishort.conf", "ishort", 4.0e6, 8.0))
STREAM_FE_CN0 = 50.0
STREAM_FE_MIN_SYNCED = 4


def _nsr_items(x, if_hz, fs):
    """Complex baseband on the card mixed up to the IF, its real part
    quantised to NSR's 2-bit code (thresholds 0 and +-1 noise sigma of the
    real part) and packed four a byte, the least significant pair first
    (io/formats.py's nsr), on the host."""
    n = torch.arange(x.shape[0], dtype=torch.float64, device=x.device)
    ang = 2.0 * np.pi * torch.remainder(n * (if_hz / fs), 1.0)
    real = x.real.double() * torch.cos(ang) - x.imag.double() * torch.sin(ang)
    q = torch.clamp(torch.floor(real / np.sqrt(0.5)), -2, 1)
    q = (q.to(torch.int32) & 3).reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
            | (q[:, 3] << 6)).to(torch.uint8).cpu().numpy()


def phase_stream_front_end(dev, cc, tc, scen):
    """Phase 35: Receiver.process_stream through the conf's front end on
    the card, each receiver built from its conf as written
    (to_receiver_config): conf/gps_l1_nsr.conf on phase 5's satellites
    generated at 20.48 Msps, mixed up to the conf's IF, quantised to NSR's
    real 2-bit code and packed; conf/gps_l1_ishort.conf on them at 4 Msps
    as ishort (its Direct_Resampler 2:1).  The launch counters set to 0
    just before each run: xlate_fir launches == segments, chunk_corr and
    track_chain launches == chunks.  The first segment's conditioned
    samples held to xlate_fir_plain on the CPU over the same raw items: the
    ishort conf's bit for bit (one tap of 1.0, no rotation); the NSR
    conf's within 2 float32 ulps of each output's magnitude (the same sums
    in the same order, the rotation's cosine and sine from the kernel's
    float64 sincospi against numpy's cos(pi a), which round to the other
    float32 now and then), its share of outputs bit for bit reported.
    Every assigned channel on a satellite of the scenario, at least
    STREAM_FE_MIN_SYNCED of them bit-synced; the front end's history kept
    on the receiver at the stream's end."""
    import dataclasses

    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
    from gnss_sdr_1_tpu_torch.ops import xlate_fir as xf
    from gnss_sdr_1_tpu_torch.runtime import Receiver
    from gnss_sdr_1_tpu_torch.runtime.config import (FileConfiguration,
                                                     to_receiver_config)

    sats = [dataclasses.replace(s, cn0_dbhz=STREAM_FE_CN0)
            for s in scen.sats]
    codes = {s.prn: gps_l1ca_code(s.prn) for s in sats}
    visible = {s.prn for s in sats}
    out = {}
    for conf, fmt, fs, dur in STREAM_FE_RUNS:
        what = f"stream {conf}"
        rc = to_receiver_config(FileConfiguration(str(ROOT / "conf" / conf)))
        t0 = time.perf_counter()
        x = generate_on_card(GPS_L1_CA, sats, codes, fs, dur, dev, seed=35)
        if fmt == "nsr":
            items = _nsr_items(x, rc.front_end.if_freq_hz, fs)
        else:
            iq = torch.stack([x.real, x.imag], dim=1) * ISHORT_SCALE
            items = torch.clamp(torch.round(iq), -32767, 32767).to(
                torch.int16).reshape(-1).cpu().numpy()
        del x
        gen_s = time.perf_counter() - t0
        rx = Receiver(rc, device=dev)
        first = {}
        cond = rx._conditioned_segment

        def rec(front, staging, seg_items, n_out, span):
            y = cond(front, staging, seg_items, n_out, span)
            if not first:
                first.update(items=np.array(seg_items), n_out=n_out,
                             y=y.cpu().numpy(), phase0=xf.fixed_phase(
                                 front.next_out - span, front.dphase),
                             front=front)
            return y

        rx._conditioned_segment = rec
        per_block = int(fs * STREAM_BLOCK_S) * (2 if fmt == "ishort" else 1) \
            // (4 if fmt == "nsr" else 1)
        with _counting(cc, tc) as counter:
            xf.launches = 0
            t0 = time.perf_counter()
            rx.process_stream(_blocks(items, per_block),
                              segment_s=STREAM_SEGMENT_S, raw_format=fmt)
            wall = time.perf_counter() - t0
            launches = xf.launches
        _check_launches(cc, tc, counter["chunks"], what)
        if launches != counter["calls"] or not launches > 0:
            raise AssertionError(f"{what}: {launches} xlate_fir launches for "
                                 f"{counter['calls']} segments")
        # the first segment against the plain version on the CPU
        fr = first["front"]
        want = xf.xlate_fir_plain(None, torch.from_numpy(first["items"]), fmt,
                                  fr.taps.cpu(), fr.decim, fr.n_hist,
                                  first["n_out"], first["phase0"], fr.dphase,
                                  1.0)
        torch.view_as_real(want).mul_(float(np.float32(rx._ingest_scale)))
        w, g = want.numpy(), first["y"]
        rms = float(np.sqrt(np.mean(np.abs(w) ** 2)))
        bits = float((g.view(np.uint64) == w.view(np.uint64)).mean())
        if fmt == "ishort" and bits != 1.0:
            raise AssertionError(f"{what}: the first segment is not "
                                 f"xlate_fir_plain's bit for bit ({bits})")
        tol = 2 * np.spacing(np.abs(w).astype(np.float32)) + 1e-7 * rms
        if not np.all(np.abs(g - w) <= tol):
            raise AssertionError(f"{what}: the first segment differs from "
                                 f"xlate_fir_plain by "
                                 f"{np.abs(g - w).max():.3e}")
        prns = list(rx.channel_prn)
        if not {p for p in prns if p is not None} <= visible:
            raise AssertionError(f"{what}: channels {prns}, visible "
                                 f"{sorted(visible)}")
        synced = [p for p in prns if p is not None
                  and rx.decoders[p].bit_offset is not None]
        if len(synced) < STREAM_FE_MIN_SYNCED:
            raise AssertionError(f"{what}: bit-synced {synced} of channels "
                                 f"{prns}")
        if rx._front_hist[:2] != (fmt, rx._abs_base):
            raise AssertionError(f"{what}: the front end's history is not "
                                 f"kept at the stream's end")
        signal_s = rx._abs_base / rc.fs_hz
        out[fmt] = {"conf": conf, "source_fs_hz": fs, "decim": fr.decim,
                    "taps": fr.n_taps, "signal_s": signal_s, "wall_s": wall,
                    "rtf": signal_s / wall, "gen_s": gen_s,
                    "segments": counter["calls"],
                    "launches_xlate_fir": launches,
                    "launches_chunk_corr": cc.launches,
                    "launches_track_chain": tc.launches,
                    "chunks": counter["chunks"], "channels": prns,
                    "bit_synced": synced,
                    "first_max_abs_diff": float(np.abs(g - w).max()),
                    "first_rms": rms, "first_bits_equal": bits}
        del rx, items
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: acquisition and the tracking engine (bench scenario)
# ---------------------------------------------------------------------------


def engine_capture(dev):
    """Phases 3-4's capture (the engine benchmark's 12 satellites, 15 s at
    4.092 Msps), made on the card with the numpy generator's noise (seed
    1234): the capture the earlier numpy runs made.  Returns (satellites,
    samples, seconds spent making them)."""
    return (_cells()["engine"][2],
            *card_capture(dev, ["engine"], 1234, numpy_noise=True))


def phase_acquisition(dev, sats, x):
    from gnss_sdr_1_tpu_torch.acquire import AcqConfig, PcpsAcquisition
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code

    prns = [s.prn for s in sats]
    cfg = AcqConfig(fs_hz=FS, samples_per_code=4092, samples_per_chip=4,
                    doppler_max_hz=5000.0, doppler_step_hz=250.0,
                    max_dwells=2, make_two_steps=False)
    codes = {p: gps_l1ca_code(p) for p in prns}
    acq = PcpsAcquisition(cfg, codes, fs_code_rate=(1.023e6, 1023),
                          device=dev)
    xs = x[: acq.cfg.fft_size * 2]
    res = acq.acquire(xs)
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        acq.acquire(xs)
    wall = (time.perf_counter() - t0) / n
    ffts = len(prns) * acq.cfg.num_doppler_bins * 2 * 2
    # the card against the same acquisition on the CPU (ROADMAP.md's bar):
    # the same detections, the same Doppler bin, the delay within 1 sample,
    # the statistics to rtol 1e-4
    ref = PcpsAcquisition(cfg, codes, fs_code_rate=(1.023e6, 1023),
                          device="cpu").acquire(xs)
    if not np.array_equal(res.positive, ref.positive):
        raise AssertionError(f"acquisition detections differ from the CPU: "
                             f"{res.positive} vs {ref.positive}")
    if not np.array_equal(res.doppler_hz, ref.doppler_hz):
        raise AssertionError(f"acquisition Doppler bins differ from the "
                             f"CPU: {res.doppler_hz} vs {ref.doppler_hz}")
    dd_cpu = np.abs(res.delay_samples - ref.delay_samples)
    dd_cpu = np.minimum(dd_cpu, 4092 - dd_cpu)
    if not (dd_cpu <= 1.0).all():
        raise AssertionError(f"acquisition delays differ from the CPU by "
                             f"{dd_cpu}")
    rel = np.abs(res.test_stat - ref.test_stat) / np.abs(ref.test_stat)
    if not (rel <= 1e-4).all():
        raise AssertionError(f"acquisition statistics differ from the CPU "
                             f"by {rel}")
    # a detection at the truth: the code delay within 2 samples and the
    # Doppler within two 250 Hz bins (the 1 ms coherent window's main lobe
    # is +-1 kHz wide, so noise picks among neighbouring bins)
    found = []
    for k, s in enumerate(sats):
        true_delay = (s.delay_chips / 1.023e6 * FS) % 4092
        dd = abs(res.delay_samples[k] - true_delay)
        dd = min(dd, 4092 - dd)
        df = abs(res.doppler_hz[k] - s.doppler_hz)
        found.append({"prn": s.prn, "stat": float(res.test_stat[k]),
                      "stat_cpu": float(ref.test_stat[k]),
                      "doppler_err_hz": float(df), "delay_err": float(dd),
                      "hit": bool(res.positive[k] and df <= 500.0
                                  and dd <= 2.0)})
    det = sum(f["hit"] for f in found)
    if det < 10:
        raise AssertionError(f"acquisition found {det}/12 satellites: "
                             f"{found}")
    return {"detected": det, "ffts_per_s": ffts / wall,
            "ms_per_call": wall * 1e3, "fft_size": acq.cfg.fft_size,
            "cpu_max_delay_diff": float(dd_cpu.max()),
            "cpu_max_stat_rel": float(rel.max()), "per_prn": found}


# symbol_slots over the main-path runs: launches, engine calls on the
# card, runs counted, and the shapes held to the plain version
SYMBOLS = {"launches": 0, "calls": 0, "runs": 0, "shapes": [], "depth": 0}


@contextlib.contextmanager
def _symbol_counting():
    """The symbol-grid kernel over the runs inside the block: its launch
    counter set to 0 first, TrackingEngine._symbol_outputs calls with
    rows on the card counted apart from it (one launch each), and the
    first call of every (cap, C, N, K) shape held bit for bit to
    symbol_slots_plain on the same rows once the run is over (a clone of
    its rows is kept).  Nested blocks count in the outermost only.  The
    run's launches, calls and shapes go into SYMBOLS."""
    from gnss_sdr_1_tpu_torch.ops import symbol_slots as ss
    from gnss_sdr_1_tpu_torch.track.engine import TrackingEngine

    if SYMBOLS["depth"]:
        SYMBOLS["depth"] += 1
        try:
            yield
        finally:
            SYMBOLS["depth"] -= 1
        return
    run = TrackingEngine._symbol_outputs
    seen = {s["shape"] for s in SYMBOLS["shapes"]}
    kept, calls = [], [0]

    def counted(self, out_f, out_i, out_corr, entering_rem, sym_off, N):
        out = run(self, out_f, out_i, out_corr, entering_rem, sym_off, N)
        if out_f.device.type == "cuda":
            calls[0] += 1
            shape = (out_f.shape[0], out_f.shape[2], int(N),
                     out_corr.shape[1] // 2)
            if shape not in seen:
                seen.add(shape)
                kept.append((shape, [t.clone() for t in (
                    out_f, out_i, out_corr, entering_rem)],
                    np.array(sym_off), self.cfg.prompt_index, out))
        return out

    TrackingEngine._symbol_outputs = counted
    ss.launches = 0
    SYMBOLS["depth"] = 1
    try:
        yield
    finally:
        TrackingEngine._symbol_outputs = run
        SYMBOLS["depth"] = 0
    if ss.launches != calls[0]:
        raise AssertionError(f"{ss.launches} symbol_slots launches for "
                             f"{calls[0]} symbol-grid calls on the card")
    for shape, t, off, prompt, out in kept:
        _symbol_bits_equal(out._asdict(), ss.symbol_slots_plain(
            *t, off, shape[2], prompt), f"main path {shape}")
        SYMBOLS["shapes"].append({"shape": shape})
    SYMBOLS["launches"] += ss.launches
    SYMBOLS["calls"] += calls[0]
    SYMBOLS["runs"] += 1


@contextlib.contextmanager
def _counting(cc, tc):
    """Set both kernels' launch counters to 0 and count the chunks that
    every TrackingEngine capture call runs inside the block (ceil(n_epochs
    / E) per call), independently of the counters, and the calls (capture
    segments); the chunked calls' chunks per chain template instance,
    keyed (K, PLL order, secondary-code data flag, secondary-code length),
    under "instances"; for an engine with a secondary code, also the
    chunks of calls that start with the wipe on in a channel, and the
    chunks of calls that start with an active channel on a non-zero FDMA
    carrier bias; the symbol-grid kernel by _symbol_counting."""
    from gnss_sdr_1_tpu_torch.track.engine import TrackingEngine

    counter = {"chunks": 0, "sec_chunks": 0, "offset_chunks": 0,
               "calls": 0, "instances": {}}
    run = TrackingEngine._run_capture

    def counted(self, samples, state, limit, n_epochs):
        chunks = -(-n_epochs // self.chain_spec.E)
        counter["chunks"] += chunks
        counter["calls"] += 1
        if self.correlator == "chunked":
            s = self.chain_spec
            key = (s.K, s.order, s.sec_data, s.sec_len)
            inst = counter["instances"]
            inst[key] = inst.get(key, 0) + chunks
        if self.chain_spec.sec_len > 1 and bool(state.sec_on.any()):
            counter["sec_chunks"] += chunks
        if bool(((state.carr_offset_hz != 0) & state.active).any()):
            counter["offset_chunks"] += chunks
        return run(self, samples, state, limit, n_epochs)

    TrackingEngine._run_capture = counted
    cc.launches = tc.launches = 0
    try:
        with _symbol_counting():
            yield counter
    finally:
        TrackingEngine._run_capture = run


def _check_launches(cc, tc, chunks, what):
    if not chunks > 0:
        raise AssertionError(f"{what}: no chunk ran")
    for name, n in (("chunk_corr", cc.launches), ("track_chain",
                                                  tc.launches)):
        if n != chunks:
            raise AssertionError(f"{what}: {n} {name} launches for {chunks} "
                                 f"chunks")


def phase_engine(dev, cc, tc, sats, x):
    eng = _engine(dev)
    st = _activate_all(eng, sats)
    nmax = eng.cfg.epoch_samples_max
    xd = torch.as_tensor(x, device=dev)
    span = len(x) - nmax
    sym_off = np.full(12, 20, dtype=np.int32)
    # first-use warm-up (kernel load) on 0.1 s
    w = int(FS * 0.1)
    eng.track_capture_symbols(xd[: w + nmax], st, w, sym_off, 20)
    torch.cuda.synchronize()
    with _counting(cc, tc) as counter:
        t0 = time.perf_counter()
        st2, souts = eng.track_capture_symbols(xd, st, span, sym_off, 20)
        n_valid = int(souts.n_valid.sum())
        wall = time.perf_counter() - t0
    chunks = counter["chunks"]
    _check_launches(cc, tc, chunks, "engine")
    signal_s = span / FS
    expected = signal_s / 1e-3 * 12
    if not n_valid > 0.85 * expected:
        raise AssertionError(f"engine: {n_valid} valid epochs of "
                             f"{expected:.0f} expected")
    if not bool(st2.active.all()):
        raise AssertionError("engine: a channel lost lock")
    return {"rtf": signal_s / wall, "wall_s": wall, "signal_s": signal_s,
            "n_valid": n_valid, "expected": expected,
            "launches_chunk_corr": cc.launches,
            "launches_track_chain": tc.launches, "chunks": chunks}


# ---------------------------------------------------------------------------
# phase 5: the receiver end to end
# ---------------------------------------------------------------------------


def e2e_capture(dev):
    """The e2e scenario (bench.py:294-348): 12 satellites, 30 s at
    4.092 Msps, live LNAV at 47 dB-Hz, made on the card with the numpy
    generator's noise (seed 1234), as engine_capture.  Returns (scenario,
    samples, seconds spent making them)."""
    return (_cells()["e2e"][0],
            *card_capture(dev, ["e2e"], 1234, numpy_noise=True))


def _errors_3d(ecef, scen, what, min_fixes, max_median_m=5.0):
    """Fix count and 3D errors against the scenario truth; raises below
    `min_fixes` fixes, on a non-finite error, or at a median 3D error of
    `max_median_m` or more (None: no median bar)."""
    ecef = np.asarray(ecef, np.float64).reshape(-1, 3)
    if len(ecef) < min_fixes:
        raise AssertionError(f"{what}: {len(ecef)} fixes (< {min_fixes})")
    e3d = np.linalg.norm(ecef - scen.rx_ecef, axis=1)
    med = float(np.median(e3d))
    if not np.isfinite(e3d).all() or (max_median_m is not None
                                      and not med < max_median_m):
        raise AssertionError(f"{what}: median 3D error {med:.2f} m")
    return {"fixes": len(ecef), "median_3d_m": med,
            "max_3d_m": float(e3d.max())}


def phase_e2e(dev, cc, tc, scen, x):
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig

    prns = [s.prn for s in scen.sats]
    rx = Receiver(ReceiverConfig(
        fs_hz=FS, signal_id="1C", n_channels=len(prns),
        prn_search=tuple(prns), reacq_interval_blocks=125,
        pvt_output_rate_ms=100), device=dev)
    rx.preload(x)
    with _counting(cc, tc) as counter:
        t0 = time.perf_counter()
        sols = rx.process(x)
        wall = time.perf_counter() - t0
    _check_launches(cc, tc, counter["chunks"], "e2e")
    return {"rtf": E2E_S / wall, "wall_s": wall,
            **_errors_3d([s.rx_ecef_m for s in sols], scen, "e2e",
                         MIN_FIXES),
            "launches_chunk_corr": cc.launches,
            "launches_track_chain": tc.launches,
            "chunks": counter["chunks"], "channels": list(rx.channel_prn),
            "last10_mean_ecef": np.mean([s.rx_ecef_m for s in sols[-10:]],
                                        axis=0).tolist(),
            "fixes_by_epoch": {round(s.rx_time_tow_s * 10): s.rx_ecef_m.tolist()
                               for s in sols}}


def e2e_seeds(dev, seeds, cpu_runs, out):
    """Phase 5's receiver over the e2e scenario with other noise: for each
    seed the capture with the card's noise and with numpy's, on the card,
    and on the CPU for the (noise, seed) pairs of `cpu_runs`.  Prints one
    line a run (fixes, first-fix time into the capture, median 3D error)
    and writes them to `out`/e2e_seeds.json.  Holds no bar: it measures
    how the fix count spreads over noise realisations."""
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig

    scen = _cells()["e2e"][0]
    prns = [s.prn for s in scen.sats]
    cpu = {(kind, int(seed)) for kind, seed in cpu_runs}
    rows = []
    for kind in ("card", "numpy"):
        for seed in seeds:
            x, gen_s = card_capture(dev, ["e2e"], seed,
                                    numpy_noise=kind == "numpy")
            for where in ("cuda", "cpu"):
                if where == "cpu" and (kind, seed) not in cpu:
                    continue
                rx = Receiver(ReceiverConfig(
                    fs_hz=FS, signal_id="1C", n_channels=len(prns),
                    prn_search=tuple(prns), reacq_interval_blocks=125,
                    pvt_output_rate_ms=100), device=where)
                rx.preload(x)
                t0 = time.perf_counter()
                sols = rx.process(x)
                wall = time.perf_counter() - t0
                e3d = (np.linalg.norm(np.stack([q.rx_ecef_m for q in sols])
                                      - scen.rx_ecef, axis=1)
                       if sols else np.array([np.nan]))
                row = {"noise": kind, "seed": seed, "device": where,
                       "fixes": len(sols),
                       "first_fix_s": (sols[0].rx_time_tow_s - scen.t0_tow
                                       if sols else None),
                       "median_3d_m": float(np.median(e3d)),
                       "channels": list(rx.channel_prn), "wall_s": wall,
                       "capture_s": gen_s}
                rows.append(row)
                first = ("none" if row["first_fix_s"] is None
                         else f"{row['first_fix_s']:.2f} s")
                log(f"[e2e seeds] {kind} noise, seed {seed}, on the "
                    f"{'card' if where == 'cuda' else 'CPU'}: fixes {row['fixes']}, first fix {first} into "
                    f"the capture, median 3D error {row['median_3d_m']:.2f} "
                    f"m | {wall:.1f} s")
            del x
    out.mkdir(parents=True, exist_ok=True)
    (out / "e2e_seeds.json").write_text(json.dumps(rows, indent=1))


# ---------------------------------------------------------------------------
# phases 6-8: the conf-file CLI
# ---------------------------------------------------------------------------


def write_cli_files(x):
    """Phase 5's capture as interleaved int16 I/Q at ISHORT_SCALE (the
    verify recipe's format), as it is and mixed up to IF_HZ.  Returns the
    two paths."""
    CACHE.mkdir(exist_ok=True)
    paths = (CACHE / f"e2e_{FS:.0f}_{E2E_S:.0f}.ishort",
             CACHE / f"e2e_{FS:.0f}_{E2E_S:.0f}_if{IF_HZ:.0f}.ishort")
    step = 1 << 22
    with open(paths[0], "wb") as f0, open(paths[1], "wb") as f1:
        for a in range(0, len(x), step):
            seg = x[a:a + step].astype(np.complex128)
            n = np.arange(a, a + len(seg), dtype=np.float64)
            mixed = seg * np.exp(2j * np.pi * IF_HZ / FS * n)
            for f, y in ((f0, seg), (f1, mixed)):
                iq = np.empty(2 * len(y), dtype=np.int16)
                iq[0::2] = np.clip(np.round(y.real * ISHORT_SCALE),
                                   -32767, 32767)
                iq[1::2] = np.clip(np.round(y.imag * ISHORT_SCALE),
                                   -32767, 32767)
                iq.tofile(f)
    return paths


def _write_conf(name, capture, tracking, fs_internal=FS, **extra):
    """A 12-channel GPS L1 C/A conf over an ishort capture at FS, PVT every
    100 ms; `extra` adds or overrides keys (dots written as '__')."""
    items = {
        "GNSS-SDR.internal_fs_sps": f"{fs_internal:.0f}",
        "SignalSource.implementation": "File_Signal_Source",
        "SignalSource.filename": str(capture),
        "SignalSource.item_type": "ishort",
        "SignalSource.sampling_frequency": f"{FS:.0f}",
        "SignalConditioner.implementation": "Pass_Through",
        "Channels_1C.count": "12",
        "Acquisition_1C.implementation": "GPS_L1_CA_PCPS_Acquisition",
        "Acquisition_1C.threshold": "2.0",
        "Acquisition_1C.doppler_max": "5000",
        "Acquisition_1C.doppler_step": "250",
        "Tracking_1C.implementation": tracking,
        "TelemetryDecoder_1C.implementation": "GPS_L1_CA_Telemetry_Decoder",
        "Observables.implementation": "Hybrid_Observables",
        "PVT.implementation": "RTKLIB_PVT",
        "PVT.positioning_mode": "Single",
        "PVT.output_rate_ms": "100",
    }
    items.update({k.replace("__", "."): str(v) for k, v in extra.items()})
    path = CACHE / name
    path.write_text("".join(f"{k}={v}\n" for k, v in items.items()))
    return path


def _run_cli(argv, scen, out_dir, min_fixes, what, max_median_m=5.0,
             joint=False, receivers=None):
    """`python -m gnss_sdr_1_tpu_torch argv` in this process, on the card
    (no --device).  Checks the exit code, the seven output files (a
    multi-group conf's joint run, `joint`: its four position files) and the
    fixes in position.geojson against the scenario truth.  Each Receiver
    the CLI ran is appended to the list `receivers`, where one is given."""
    from gnss_sdr_1_tpu_torch.__main__ import main as cli_main
    from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
    from gnss_sdr_1_tpu_torch.runtime.config import FrontEnd
    from gnss_sdr_1_tpu_torch.runtime.receiver import Receiver

    # the walls of Receiver.process and of the conditioner (FrontEnd.process,
    # host-to-card copy and back included) and the signal length, unrounded
    proc, cond, seen = Receiver.process, FrontEnd.process, {}

    def timed_process(self, samples):
        # a multi-group conf runs one Receiver.process per group: their sum
        t = time.perf_counter()
        if receivers is not None:
            receivers.append(self)
        try:
            return proc(self, samples)
        finally:
            seen.update(wall=seen.get("wall", 0.0) + time.perf_counter() - t,
                        signal_s=len(samples) / self.cfg.fs_hz)

    def timed_condition(self, x, device=None):
        t = time.perf_counter()
        try:
            return cond(self, x, device=device)
        finally:
            seen["condition_s"] = time.perf_counter() - t

    buf = io.StringIO()
    Receiver.process, FrontEnd.process = timed_process, timed_condition
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_main(list(argv) + ["--out_dir", str(out_dir)])
    finally:
        Receiver.process, FrontEnd.process = proc, cond
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for ln in lines:
        log(f"    | {ln}")
    if rc != 0:
        raise AssertionError(f"{what}: the CLI exited with {rc}")
    m = re.search(r"Processed in \S+ s \(RTF \S+x\); (\d+) "
                  + ("joint " if joint else "") + "PVT fixes", buf.getvalue())
    if m is None:
        raise AssertionError(f"{what}: no 'Processed in' line")
    files = OUTPUT_FILES[:4] if joint else OUTPUT_FILES
    if int(m.group(1)) == 0 and min_fixes == 0:
        # a run without a fix (no bar on fixes): it says so, writes nothing
        if lines[-1] != ("No joint position fix obtained." if joint
                         else "No position fix obtained."):
            raise AssertionError(f"{what}: last line {lines[-1]!r}")
        rep = {"fixes": 0, "median_3d_m": float("nan"),
               "process_wall_s": seen["wall"], "signal_s": seen["signal_s"],
               "process_rtf": seen["signal_s"] / seen["wall"],
               "cli_wall_s": wall, "cli_rtf": seen["signal_s"] / wall,
               "condition_s": seen.get("condition_s"), "lines": lines}
        rep["summary"] = (f"exit 0, RTF {rep['process_rtf']:.2f} of "
                          f"Receiver.process, no fix")
        return rep
    missing = [n for n in files if not (out_dir / n).is_file()]
    if missing:
        raise AssertionError(f"{what}: output files missing: {missing}")
    coords = json.loads((out_dir / "position.geojson").read_text())[
        "geometry"]["coordinates"]
    lon, lat, h = np.asarray(coords, np.float64).reshape(-1, 3).T
    ecef = np.stack(llh_to_ecef(np.radians(lat), np.radians(lon), h), -1)
    if len(ecef) != int(m.group(1)):
        raise AssertionError(f"{what}: {len(ecef)} positions in the GeoJSON "
                             f"for {m.group(1)} fixes")
    rep = _errors_3d(ecef, scen, what, min_fixes, max_median_m)
    rep.update(process_wall_s=seen["wall"], signal_s=seen["signal_s"],
               process_rtf=seen["signal_s"] / seen["wall"], cli_wall_s=wall,
               cli_rtf=seen["signal_s"] / wall,
               condition_s=seen.get("condition_s"), lines=lines)
    rep["summary"] = (
        f"exit 0, RTF {rep['process_rtf']:.2f} of Receiver.process "
        f"({seen['wall']:.2f} s; {rep['cli_rtf']:.2f} for the whole CLI, "
        f"{wall:.2f} s), "
        f"fixes {rep['fixes']}, median 3D error {rep['median_3d_m']:.2f} m, "
        f"{len(files)} output files")
    return rep


def _cli_launches(cc, tc, rep, counter, what):
    _check_launches(cc, tc, counter["chunks"], what)
    rep.update(launches_chunk_corr=cc.launches,
               launches_track_chain=tc.launches, chunks=counter["chunks"])
    rep["summary"] += (f", launches chunk_corr {cc.launches} track_chain "
                       f"{tc.launches} == chunks {counter['chunks']}")
    return rep


def phase_cli_passthrough(cc, tc, scen, capture):
    conf = _write_conf("cli_passthrough.conf", capture,
                       "GPS_L1_CA_DLL_PLL_Tracking")
    with _counting(cc, tc) as counter:
        rep = _run_cli(["-c", str(conf)], scen, CACHE / "cli_passthrough",
                       MIN_FIXES, "CLI pass-through")
    return _cli_launches(cc, tc, rep, counter, "CLI pass-through")


def phase_cli_if(dev, cc, tc, scen, capture):
    from gnss_sdr_1_tpu_torch.io import FileSignalSource
    from gnss_sdr_1_tpu_torch.runtime.config import (FileConfiguration,
                                                     build_frontend)

    conf = _write_conf(
        "cli_if.conf", capture, "GPS_L1_CA_DLL_PLL_Tracking",
        fs_internal=FS_IF, SignalSource__freq_IF=f"{IF_HZ:.0f}",
        SignalConditioner__implementation="Signal_Conditioner",
        DataTypeAdapter__implementation="Pass_Through",
        InputFilter__implementation="Freq_Xlating_Fir_Filter",
        InputFilter__IF=f"{IF_HZ:.0f}", InputFilter__number_of_taps=65,
        Resampler__implementation="Pass_Through")
    # the conditioner on the card against the same FrontEnd on the CPU
    fe = build_frontend(FileConfiguration(str(conf)))
    check_s = 0.5
    head = FileSignalSource(str(capture), item_type="ishort",
                            sampling_frequency=FS).read(0, int(FS * check_s))
    got = fe.process(head, device=dev)
    want = fe.process(head, device="cpu")
    if got.shape != want.shape or got.shape[0] != int(FS_IF * check_s):
        raise AssertionError(f"conditioner shapes {got.shape} {want.shape}")
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if not err <= 1e-4 * scale:
        raise AssertionError(f"conditioner on the card differs from the "
                             f"CPU: {err:.3e} > 1e-4 x {scale:.3e}")
    with _counting(cc, tc) as counter:
        rep = _run_cli(["-c", str(conf)], scen, CACHE / "cli_if",
                       MIN_FIXES_IF, "CLI IF")
    rep.update(cond_err=err, cond_scale=scale, cond_check_s=check_s)
    return _cli_launches(cc, tc, rep, counter, "CLI IF")


def _trace_events(prof):
    """Every event of a finished torch.profiler run."""
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        data = json.loads(path.read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


@contextlib.contextmanager
def _kf_counting(kb):
    """Set the KF kernel's launch counter to 0 and count the engine calls
    (KfTrackingEngine.track_blocks), the blocks and the epochs they walk,
    independently of the counter; CUDA events around every kf_block launch
    give its device time (`kf_device_ms`, summed once the run is over:
    recording an event does not wait for the card)."""
    from gnss_sdr_1_tpu_torch.track.kf import KfTrackingEngine

    counter = {"calls": 0, "blocks": 0, "epochs": 0}
    run = KfTrackingEngine.track_blocks
    launch = kb.kf_block_cuda
    events = []

    def counted(self, samples, state, base, n_blocks=1):
        counter["calls"] += 1
        counter["blocks"] += n_blocks
        counter["epochs"] += n_blocks * self.block_spec(base, n_blocks).n_epochs
        return run(self, samples, state, base, n_blocks)

    def timed(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch(*args, **kw)
        b.record()
        events.append((a, b))
        return out

    KfTrackingEngine.track_blocks = counted
    kb.kf_block_cuda = timed
    kb.launches = 0
    try:
        yield counter
    finally:
        KfTrackingEngine.track_blocks = run
        kb.kf_block_cuda = launch
        torch.cuda.synchronize()
        counter["kf_device_ms"] = sum(a.elapsed_time(b) for a, b in events)
        counter["kf_device_us_per_epoch"] = (
            counter["kf_device_ms"] / max(counter["epochs"], 1) * 1e3)


def _check_kf_launches(kb, counter, what):
    """One kf_block launch per engine call, and at least one call."""
    if not counter["calls"] > 0:
        raise AssertionError(f"{what}: no KF block ran")
    if kb.launches != counter["calls"]:
        raise AssertionError(f"{what}: {kb.launches} kf_block launches for "
                             f"{counter['calls']} engine calls")


def _graph_kernels(call):
    """The kernel launches `call()` makes on the current stream, counted
    exactly as the kernel nodes of a CUDA graph captured from it (the
    libcuda's cuGraphGetNodes / cuGraphNodeGetType).  torch.profiler's trace
    is not used: on the H100 (torch 2.11) traces of this call taken late in
    this script came back without its kernels."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        call()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    graph.reset()
    return kinds.count(0)              # CU_GRAPH_NODE_TYPE_KERNEL


def _kf_block_profile(dev, kb, scen, capture):
    """Kernel launches, device time and wall per KF epoch as the receiver
    calls the engine: one capture segment of KF_SEG_BLOCKS 40 ms blocks of
    12 channels (activated at the scenario's Dopplers and delays), after a
    warm-up segment.  The launches of one engine call's device part (the
    state packed, kf_block, the state unpacked; the output readback
    launches nothing) are counted in a CUDA graph captured from it (one
    block alone too); the next segment's kf_block and whole device part
    are timed with CUDA events, and the segment after it from the host."""
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.io import FileSignalSource
    from gnss_sdr_1_tpu_torch.track.kf import KfTrackConfig, KfTrackingEngine

    eng = KfTrackingEngine(
        KfTrackConfig(fs_hz=FS, code_length_chips=1023,
                      chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                      n_channels=len(scen.sats)),
        np.stack([gps_l1ca_code(s.prn) for s in scen.sats]), device=dev)
    base = int(FS * 0.04)
    nmax = eng.cfg.epoch_samples_max
    seg = KF_SEG_BLOCKS * base
    spec = eng.block_spec(base, KF_SEG_BLOCKS)
    n_ep = KF_SEG_BLOCKS * spec.n_epochs
    x = torch.as_tensor(FileSignalSource(
        str(capture), item_type="ishort", sampling_frequency=FS).read(
            0, 3 * seg + base + nmax), device=dev)
    st = eng.init_state()
    for ch, s in enumerate(scen.sats):
        st = eng.activate_channel(st, ch, ch,
                                  (s.delay_chips % 1023) / 1.023e6 * FS,
                                  s.doppler_hz, 0, 0, doppler_step_hz=250.0)
    st, _ = eng.track_blocks(x[: seg + nmax], st, base, KF_SEG_BLOCKS)
    torch.cuda.synchronize()

    def device_part(sp, xs, state):
        fst, ist = eng.pack_state(state)
        out = kb.kf_block(sp, xs, eng._codes, fst, ist)
        return eng.unpack_state(out[2], out[3])

    before = kb.launches
    n_kern = _graph_kernels(lambda: device_part(spec, x[seg: 2 * seg + nmax],
                                                st))
    n_kern_b = _graph_kernels(lambda: device_part(
        eng.block_spec(base, 1), x[seg: seg + base + nmax], st))
    if kb.launches - before != 2:
        raise AssertionError(f"KF profile: {kb.launches - before} kf_block "
                             f"launches in two captured engine calls")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    fst, ist = eng.pack_state(st)
    ev[1].record()
    out = kb.kf_block(spec, x[seg: 2 * seg + nmax], eng._codes, fst, ist)
    ev[2].record()
    st = eng.unpack_state(out[2], out[3])
    ev[3].record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, outs = eng.track_blocks(x[2 * seg: 3 * seg + nmax], st, base,
                                KF_SEG_BLOCKS)
    wall = time.perf_counter() - t0
    if not outs.valid.any():
        raise AssertionError("KF profile segment tracked no valid epoch")
    n_ep_b = eng.block_spec(base, 1).n_epochs
    rep = {"segment_blocks": KF_SEG_BLOCKS, "epochs": n_ep,
           "kernels_per_call": n_kern,
           "launches_per_epoch": n_kern / n_ep,
           "kf_device_us_per_epoch": ev[1].elapsed_time(ev[2]) / n_ep * 1e3,
           "device_us_per_epoch": ev[0].elapsed_time(ev[3]) / n_ep * 1e3,
           "wall_ms_per_epoch": wall / n_ep * 1e3,
           "block_epochs": n_ep_b, "block_kernels": n_kern_b,
           "block_launches_per_epoch": n_kern_b / n_ep_b}
    if not (n_kern >= 1 and rep["launches_per_epoch"] <= 0.1):
        raise AssertionError(f"KF profile: {n_kern} kernels in one engine "
                             f"call, {rep['launches_per_epoch']:.3f} per "
                             f"epoch")
    return rep


def phase_cli_kf(dev, cc, tc, kb, scen, capture):
    """The CLI with GPS_L1_CA_KF_Tracking on phase 6's file: the bars of
    tests/test_kf_tracking.py, one kf_block launch per engine call, no
    launch of the DLL/PLL kernels, the CLI at real time or faster; then
    the engine's segment profiled."""
    conf = _write_conf("cli_kf.conf", capture, "GPS_L1_CA_KF_Tracking")
    with _counting(cc, tc), _kf_counting(kb) as kc:
        rep = _run_cli(["-c", str(conf)], scen, CACHE / "cli_kf",
                       MIN_FIXES_KF, "CLI KF")
    _check_kf_launches(kb, kc, "CLI KF")
    if cc.launches or tc.launches:
        raise AssertionError(f"CLI KF: {cc.launches} + {tc.launches} "
                             f"DLL/PLL launches")
    if not rep["cli_rtf"] >= 1.0:
        raise AssertionError(f"CLI KF: RTF {rep['cli_rtf']:.3f} below real "
                             f"time")
    rep.update(kf_epochs=kc["epochs"], kf_blocks=kc["blocks"],
               kf_calls=kc["calls"], launches_kf_block=kb.launches,
               kf_device_us_per_epoch=kc["kf_device_us_per_epoch"],
               ms_per_epoch=rep["process_wall_s"] / kc["epochs"] * 1e3,
               profile=_kf_block_profile(dev, kb, scen, capture))
    return rep


def phase_cli_kalman(dev, kb):
    """conf/gps_l1_kalman.conf as written (2.6 Msps gr_complex, 8 channels,
    the NIW covariance on) over the e2e scenario made on the card at its
    rate and written as a gr_complex file (deleted after the run), at the
    KF bars and real time."""
    scen = _cells()["kalman"][0]
    x, gen_s = card_capture(dev, ["kalman"], 1234)
    CACHE.mkdir(exist_ok=True)
    path = CACHE / f"kalman_{FS_KALMAN:.0f}_{E2E_S:.0f}.gr_complex"
    x.tofile(path)
    del x
    try:
        with _kf_counting(kb) as kc:
            rep = _run_cli(["-c", str(ROOT / "conf" / "gps_l1_kalman.conf"),
                            "--signal_file", str(path)], scen,
                           CACHE / "cli_kalman", MIN_FIXES_KF,
                           "gps_l1_kalman.conf")
    finally:
        path.unlink(missing_ok=True)
    _check_kf_launches(kb, kc, "gps_l1_kalman.conf")
    if not rep["cli_rtf"] >= 1.0:
        raise AssertionError(f"gps_l1_kalman.conf: RTF {rep['cli_rtf']:.3f} "
                             f"below real time")
    rep.update(kf_epochs=kc["epochs"], kf_blocks=kc["blocks"],
               launches_kf_block=kb.launches, gen_s=gen_s,
               kf_device_us_per_epoch=kc["kf_device_us_per_epoch"])
    return rep


# ---------------------------------------------------------------------------
# phases 23-27: the gather DLL/PLL path end to end, and the TCP connector
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _gather_counting(gb):
    """Set the gather kernel's launch counter to 0 and count the gather
    engine calls (TrackingEngine._run_capture on a 'gather' engine) and the
    epochs they walk, independently of the counter; CUDA events around
    every gather_block launch give its device time (summed once the run is
    over); the symbol-grid kernel by _symbol_counting."""
    from gnss_sdr_1_tpu_torch.track.engine import TrackingEngine

    counter = {"calls": 0, "epochs": 0, "chunked_calls": 0}
    run = TrackingEngine._run_capture
    launch = gb.gather_block_cuda
    events = []

    def counted(self, samples, state, limit, n_epochs):
        if self.correlator == "gather":
            counter["calls"] += 1
            counter["epochs"] += n_epochs
        else:
            counter["chunked_calls"] += 1
        return run(self, samples, state, limit, n_epochs)

    def timed(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch(*args, **kw)
        b.record()
        events.append((a, b))
        return out

    TrackingEngine._run_capture = counted
    gb.gather_block_cuda = timed
    gb.launches = 0
    try:
        with _symbol_counting():
            yield counter
    finally:
        TrackingEngine._run_capture = run
        gb.gather_block_cuda = launch
        torch.cuda.synchronize()
        counter["device_ms"] = sum(a.elapsed_time(b) for a, b in events)
        counter["device_us_per_epoch"] = (
            counter["device_ms"] / max(counter["epochs"], 1) * 1e3)


def _check_gather_launches(gb, counter, what):
    """One gather_block launch per gather engine call (capture segment),
    at least one, and no chunked call."""
    if not counter["calls"] > 0 or counter["chunked_calls"]:
        raise AssertionError(f"{what}: {counter['calls']} gather and "
                             f"{counter['chunked_calls']} chunked engine "
                             f"calls")
    if gb.launches != counter["calls"]:
        raise AssertionError(f"{what}: {gb.launches} gather_block launches "
                             f"for {counter['calls']} engine calls")


def _gather_run(dev, gb, cfg, x, duration_s):
    """A Receiver of `cfg` on the card over the preloaded capture, counted
    by _gather_counting: (receiver, solutions, wall seconds, counter)."""
    from gnss_sdr_1_tpu_torch.runtime import Receiver

    rx = Receiver(cfg, device=dev)
    if rx.trk.correlator != "gather":
        raise AssertionError(f"receiver built a {rx.trk.correlator} engine")
    rx.preload(x)
    with _gather_counting(gb) as counter:
        t0 = time.perf_counter()
        sols = rx.process(x)
        wall = time.perf_counter() - t0
    return rx, sols, wall, counter


def phase_gather_e2e(dev, gb, scen, x):
    """Phase 23: phase 5's receiver on the gather correlator over phase 5's
    capture: launches == segments, fixes and median 3D error at phase 5's
    bars, Receiver.process RTF and the kernel's device us per epoch."""
    from gnss_sdr_1_tpu_torch.runtime import ReceiverConfig

    prns = [s.prn for s in scen.sats]
    cfg = ReceiverConfig(fs_hz=FS, signal_id="1C", n_channels=len(prns),
                         prn_search=tuple(prns), reacq_interval_blocks=125,
                         pvt_output_rate_ms=100, correlator="gather")
    rx, sols, wall, c = _gather_run(dev, gb, cfg, x, E2E_S)
    _check_gather_launches(gb, c, "gather e2e")
    return {"rtf": E2E_S / wall, "wall_s": wall,
            **_errors_3d([s.rx_ecef_m for s in sols], scen, "gather e2e",
                         MIN_FIXES),
            "launches_gather_block": gb.launches, "segments": c["calls"],
            "epochs": c["epochs"], "device_ms": c["device_ms"],
            "device_us_per_epoch": c["device_us_per_epoch"],
            "channels": list(rx.channel_prn)}


def phase_gather_system(dev, gb, name):
    """Phases 24 (Galileo E1B) and 25 (BeiDou B1I): tests/test_system_
    galileo.py's and tests/test_system_beidou.py's 5-satellite scenarios at
    4 Msps, the captures made on the card with numpy's noise (the tests'
    captures to float32 rounding), through those tests' receiver
    configurations on the gather correlator, at their bars (ephemerides,
    fixes, median 3D error and mean-bias norm under 5 m)."""
    from gnss_sdr_1_tpu_torch.runtime import ReceiverConfig

    scen, _, sats, _, fs, dur = _cells()[name]
    x, gen_s = card_capture(dev, [name], 1234, numpy_noise=True)
    prns = tuple(s.prn for s in sats)
    if name == "sys 1B":
        cfg = ReceiverConfig(fs_hz=fs, signal_id="1B", n_channels=5,
                             prn_search=prns, acq_dwells=3, pll_bw_hz=15.0,
                             dll_bw_hz=2.0, correlator="gather")
    else:
        cfg = ReceiverConfig(fs_hz=fs, signal_id="B1", n_channels=5,
                             prn_search=prns, acq_dwells=3,
                             acq_bit_transition=True, pll_bw_hz=18.0,
                             dll_bw_hz=2.0, early_late_space_chips=0.2,
                             doppler_step2_hz=15.0,
                             num_doppler_bins_step2=40, correlator="gather")
    what = f"gather {name}"
    rx, sols, wall, c = _gather_run(dev, gb, cfg, x, dur)
    del x
    _check_gather_launches(gb, c, what)
    ephs = {p: d.ephemeris for p, d in rx.decoders.items()
            if d.ephemeris_complete}
    rep = _bds_bars(ephs, [s.rx_ecef_m for s in sols], scen, what,
                    None if name == "sys 1B" else "C")
    if rep["failed"]:
        raise AssertionError("; ".join(rep["failed"]))
    return {**rep, "rtf": dur / wall, "wall_s": wall, "gen_s": gen_s,
            "launches_gather_block": gb.launches, "segments": c["calls"],
            "epochs": c["epochs"],
            "device_us_per_epoch": c["device_us_per_epoch"],
            "channels": list(rx.channel_prn)}


def phase_cli_gather(gb, scen, capture):
    """Phase 26: conf/gps_l1_ishort.conf with Tracking_1C.correlator=gather
    added, over phase 6's capture (_ishort_conf: 4.092 Msps resampled to
    2.046 Msps, 12 channels, the rest as written, PVT every 20 ms), through
    the CLI on the card at phase 6's bars."""
    path = _ishort_conf("cli_gather.conf", capture,
                        Tracking_1C__correlator="gather")
    with _gather_counting(gb) as c:
        rep = _run_cli(["-c", str(path)], scen, CACHE / "cli_gather",
                       MIN_FIXES, "CLI gather")
    _check_gather_launches(gb, c, "CLI gather")
    rep.update(launches_gather_block=gb.launches, segments=c["calls"],
               device_us_per_epoch=c["device_us_per_epoch"])
    rep["summary"] += (f", gather_block launches {gb.launches} == segments "
                       f"{c['calls']}, {c['device_us_per_epoch']:.2f} us of "
                       f"gather_block device time per epoch")
    return rep


# the controller as an external process runs it: tests/test_tcp_
# connector.py's LoopClosureServer in a Python process of its own, its port
# on the first line of its output; it ends when the tracker hangs up
TCP_SERVER_PROCESS = (
    "import sys; sys.path.insert(0, sys.argv[1]); "
    "from gnss_sdr_1_tpu_torch.track.tcp_connector import "
    "LoopClosureServer; "
    "s = LoopClosureServer(pll_bw_hz=20.0, dll_bw_hz=2.0, "
    "seed_doppler_hz=800.0); print(s.port, flush=True); s._thread.join()")


@contextlib.contextmanager
def _tcp_controller(external):
    """The port of tests/test_tcp_connector.py's controller: a thread of
    this process, or (`external`) a process of its own, stopped on exit."""
    if not external:
        from gnss_sdr_1_tpu_torch.track.tcp_connector import (
            LoopClosureServer)

        srv = LoopClosureServer(pll_bw_hz=20.0, dll_bw_hz=2.0,
                                seed_doppler_hz=800.0)
        try:
            yield srv.port
        finally:
            srv.close()
        return
    proc = subprocess.Popen([sys.executable, "-c", TCP_SERVER_PROCESS,
                             str(ROOT)], stdout=subprocess.PIPE, text=True)
    try:
        yield int(proc.stdout.readline())
    finally:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _tcp_run(x, fs, n_epochs, device=None, stamps=None, profiled=False,
             external=False):
    """tests/test_tcp_connector.py's tracker (PRN 3, the controller seeded
    20 Hz off) over `x`, the controller a thread or (`external`) a process:
    (rows, wall seconds, the trace events of the epochs where `profiled`:
    the tracker is built outside the profiler, so its code upload is not
    in the trace)."""
    from torch.profiler import ProfilerActivity, profile

    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.track.tcp_connector import (
        TcpConnectorTracking, TcpTrackConfig)

    with _tcp_controller(external) as port:
        trk = TcpConnectorTracking(
            TcpTrackConfig(fs, 1023, 1.023e6, 1575.42e6), gps_l1ca_code(3),
            "127.0.0.1", port, device=device)
        try:
            if device is None and trk.device.type != "cuda":
                raise AssertionError("the TCP connector did not default to "
                                     "the card")
            trk.seed(257.3 / 1.023e6 * fs, 800.0)
            with (profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
                  if profiled else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                rows = trk.track(x, n_epochs, stamps)
                wall = time.perf_counter() - t0
                if trk.device.type == "cuda":
                    torch.cuda.synchronize()
        finally:
            trk.close()
    return rows, wall, _trace_events(prof) if profiled else None


def _epoch_split(stamps):
    """Mean and p90 in ms of each part of an epoch of the TCP connector
    from track()'s stamps (tcp_connector.EPOCH_STAMPS): the correlator
    call on the host, the readback, the JSON write and flush, the wait for
    the reply, the NCO (its epoch parameters and its stepping)."""
    t = np.asarray(stamps, np.float64) * 1e3
    parts = {"correlate": t[:, 2] - t[:, 1], "readback": t[:, 3] - t[:, 2],
             "json_write": t[:, 4] - t[:, 3], "reply": t[:, 5] - t[:, 4],
             "nco": (t[:, 1] - t[:, 0]) + (t[:, 6] - t[:, 5]),
             "epoch": t[:, 6] - t[:, 0]}
    return {k: {"mean_ms": float(v.mean()),
                "p90_ms": float(np.percentile(v, 90))}
            for k, v in parts.items()}


def phase_tcp(dev, mc):
    """Phase 27: tests/test_tcp_connector.py's scenario (PRN 3 at 820 Hz,
    50 dB-Hz, 1.2 s at 2.046 Msps, the controller seeded 20 Hz off) with
    the tracker's correlation on the card: one multicorrelate_cuda launch
    per epoch, and that test's bars (>= 900 epochs, the tail Doppler within
    3 Hz of the truth, the tail prompt above 0.7 of the head's); each
    epoch's wall split by the tracker's stamps; the first TCP_CPU_EPOCHS
    rows held to the same tracker on the CPU at
    tests/test_torch_tcp_connector.py::test_rows_match_the_jax_tracker's
    bars (the same starts, Doppler within 1e-2 Hz, prompts within 1e-4 of
    their scale); TCP_PROFILE_EPOCHS epochs profiled, the capture already
    on the card: the kernels and copies they make (the check that they
    make no host-to-device copy and launch nothing but the multicorrelator
    is the caller's); then the 1000 epochs again with the controller in a
    process of its own, as an external loop runs (the same rows, launches
    == epochs, the wall and its split: in this process the controller's
    thread shares the interpreter lock with the tracker)."""
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
    from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband

    fs, true_dop = TCP_FS, 820.0
    x = generate_baseband(
        GPS_L1_CA, [SatParams(prn=3, doppler_hz=true_dop, delay_chips=257.3,
                              cn0_dbhz=50.0)],
        {3: gps_l1ca_code(3)}, fs, 1.2, noise=True, seed=2)
    stamps = []
    mc.launches = 0
    rows, wall, _ = _tcp_run(x, fs, 1000, stamps=stamps)
    launches = mc.launches
    tail = np.array([r["doppler_hz"] for r in rows[-100:]])
    p_tail = np.array([abs(r["prompt"]) for r in rows[-100:]])
    p_head = np.array([abs(r["prompt"]) for r in rows[:50]])
    if not (len(rows) >= 900 and launches == len(rows)
            and abs(tail.mean() - true_dop) < 3.0
            and p_tail.mean() > 0.7 * p_head.mean()):
        raise AssertionError(f"TCP connector: {len(rows)} epochs, "
                             f"{launches} launches, tail Doppler "
                             f"{tail.mean():.2f} Hz, prompt tail/head "
                             f"{p_tail.mean() / p_head.mean():.3f}")
    cpu, _, _ = _tcp_run(x, fs, TCP_CPU_EPOCHS, device="cpu")
    card = rows[:TCP_CPU_EPOCHS]
    pc = np.array([r["prompt"] for r in cpu])
    pg = np.array([r["prompt"] for r in card])
    dop = float(np.abs(np.subtract([r["doppler_hz"] for r in card],
                                   [r["doppler_hz"] for r in cpu])).max())
    prompt = float(np.abs(pg - pc).max())
    scale = float(np.abs(pc).max())
    if not (len(cpu) == len(card) == TCP_CPU_EPOCHS
            and [r["start"] for r in card] == [r["start"] for r in cpu]
            and dop <= 1e-2 and prompt <= 1e-4 * scale):
        raise AssertionError(f"TCP connector: the card's rows part from the "
                             f"CPU's (Doppler {dop:.2e} Hz, prompt "
                             f"{prompt:.2e} of {scale:.3e})")
    x_dev = torch.as_tensor(x, device=dev)
    torch.cuda.synchronize()
    for _ in range(3):         # the profiler loses events now and then
        _, _, events = _tcp_run(x_dev, fs, TCP_PROFILE_EPOCHS, profiled=True)
        if any(e.get("cat") == "kernel" and "multicorrelate_kernel" in
               e["name"] for e in events):
            break
    ext_stamps = []
    mc.launches = 0
    ext, ext_wall, _ = _tcp_run(x, fs, 1000, stamps=ext_stamps, external=True)
    if not (mc.launches == len(ext) == len(rows)
            and [r["start"] for r in ext] == [r["start"] for r in rows]):
        raise AssertionError(f"TCP connector, the controller in a process "
                             f"of its own: {len(ext)} epochs, {mc.launches} "
                             f"launches, the rows part from the thread's")
    return {"epochs": len(rows), "launches_multicorrelate": launches,
            "external_ms_per_epoch": ext_wall / len(ext) * 1e3,
            "external_split": _epoch_split(ext_stamps),
            "tail_doppler_err_hz": float(tail.mean() - true_dop),
            "prompt_tail_over_head": float(p_tail.mean() / p_head.mean()),
            "wall_s": wall, "ms_per_epoch": wall / len(rows) * 1e3,
            "split": _epoch_split(stamps),
            "cpu_epochs": len(cpu), "cpu_doppler_diff_hz": dop,
            "cpu_prompt_diff": prompt, "cpu_prompt_scale": scale,
            "profile_epochs": TCP_PROFILE_EPOCHS,
            "profile_kernels": _by_name(events, TCP_PROFILE_EPOCHS),
            "profile_copies": _by_name(events, TCP_PROFILE_EPOCHS,
                                       "gpu_memcpy")}


# ---------------------------------------------------------------------------
# phases 28-30: the streaming receiver, the rtl_tcp source, checkpoint/resume
# ---------------------------------------------------------------------------


def _e2e_config(**kw):
    """Phase 5's receiver configuration."""
    from gnss_sdr_1_tpu_torch.runtime import ReceiverConfig

    prns = tuple(s.prn for s in _cells()["e2e"][0].sats)
    return ReceiverConfig(fs_hz=FS, signal_id="1C", n_channels=len(prns),
                          prn_search=prns, reacq_interval_blocks=125,
                          pvt_output_rate_ms=100, **kw)


def _blocks(items, per_block):
    for pos in range(0, len(items), per_block):
        yield pos, items[pos:pos + per_block]


def _udp_listener():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    return sock


def _datagrams(sock):
    """Datagrams waiting on a UDP socket (which is closed)."""
    sock.setblocking(False)
    n = 0
    while True:
        try:
            sock.recv(1 << 16)
        except BlockingIOError:
            break
        n += 1
    sock.close()
    return n


@contextlib.contextmanager
def _stream_timeline():
    """Timeline of a process_stream run: CUDA events around every
    segment's launch (TrackingEngine.launch_capture) and host timestamps
    around every harvest (Receiver._harvest_segment), put on one clock by
    an event recorded and waited for at a known host time; and the bytes
    staged to the card (PinnedStaging.upload).  On exit: the share of the
    harvest wall during which the next segment was on the device (the
    harvests that have a next segment), the device span of a segment and
    the harvest wall, each a mean."""
    from gnss_sdr_1_tpu_torch.runtime.receiver import Receiver
    from gnss_sdr_1_tpu_torch.runtime.stream import PinnedStaging
    from gnss_sdr_1_tpu_torch.track.engine import TrackingEngine

    launch = TrackingEngine.launch_capture
    harvest = Receiver._harvest_segment
    upload = PinnedStaging.upload
    events, harvests = [], []
    tl = {"h2d_bytes": 0}

    def timed_launch(self, *a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = launch(self, *a, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    def timed_harvest(self, *a, **kw):
        launched = len(events)
        h0 = time.perf_counter()
        out = harvest(self, *a, **kw)
        harvests.append((h0, time.perf_counter(), launched))
        return out

    def counted_upload(self, seg):
        tl["h2d_bytes"] += np.asarray(seg).nbytes
        return upload(self, seg)

    torch.cuda.synchronize()
    ref = torch.cuda.Event(enable_timing=True)
    ref.record()
    ref.synchronize()
    t_ref = time.perf_counter()
    TrackingEngine.launch_capture = timed_launch
    Receiver._harvest_segment = timed_harvest
    PinnedStaging.upload = counted_upload
    try:
        yield tl
    finally:
        TrackingEngine.launch_capture = launch
        Receiver._harvest_segment = harvest
        PinnedStaging.upload = upload
        torch.cuda.synchronize()
    spans = [(t_ref + ref.elapsed_time(a) * 1e-3,
              t_ref + ref.elapsed_time(b) * 1e-3) for a, b in events]
    over = wall = 0.0
    for m, (h0, h1, launched) in enumerate(harvests):
        if m + 1 >= launched:
            continue                # no segment launched after this one
        d0, d1 = spans[m + 1]
        over += max(0.0, min(h1, d1) - max(h0, d0))
        wall += h1 - h0
    tl.update(segments=len(events), harvests=len(harvests),
              overlap_share=over / wall if wall > 0 else 0.0,
              segment_device_ms=float(np.mean([d1 - d0 for d0, d1 in spans])
                                      * 1e3),
              harvest_ms=float(np.mean([h1 - h0 for h0, h1, _ in harvests])
                               * 1e3))


def _same_epochs(sols, e2e, what, min_share):
    """The stream's fixes against phase 5's process() fixes over the
    stream's span [first fix, last fix] (PVT epochs keyed by tenths of a
    second of receiver time): the share of process()'s epochs there that
    the stream solved too (at least `min_share`, else raises), and the
    median distance between the two fixes of an epoch."""
    ref = e2e["fixes_by_epoch"]
    got = {round(s.rx_time_tow_s * 10): s.rx_ecef_m for s in sols}
    span = [k for k in ref if min(got) <= k <= max(got)]
    same = [k for k in span if k in got]
    share = len(same) / max(len(span), 1)
    if not share >= min_share:
        raise AssertionError(f"{what}: {len(same)} of process()'s "
                             f"{len(span)} fixes over the stream's span")
    return {"process_fixes_in_span": len(span), "same_epochs": len(same),
            "same_epoch_median_diff_m": float(np.median(
                [np.linalg.norm(got[k] - np.asarray(ref[k])) for k in same]))}


def _stream_run(dev, items, fmt, scen, what, min_fixes, max_median_m,
                pvt_monitor=False, **cfg_kw):
    """Phase 5's receiver on the card over `items` (raw `fmt` items, or
    complex64 samples for fmt None) in STREAM_BLOCK_S blocks through
    process_stream, STREAM_SEGMENT_S segments, timed by _stream_timeline;
    with `pvt_monitor`, the PVT monitor on a localhost UDP socket (one
    datagram a fix).  Fixes and median 3D error at the bars given;
    the solutions under "sols"."""
    from gnss_sdr_1_tpu_torch.io.formats import FORMATS
    from gnss_sdr_1_tpu_torch.runtime import Receiver

    per_block = int(FS * STREAM_BLOCK_S)
    if fmt is not None:
        f = FORMATS[fmt]
        per_block = per_block * f.items_per_sample // f.samples_per_item
    sock = _udp_listener() if pvt_monitor else None
    if sock is not None:
        cfg_kw.update(enable_pvt_monitor=True,
                      pvt_monitor_port=sock.getsockname()[1])
    rx = Receiver(_e2e_config(**cfg_kw), device=dev)
    with _stream_timeline() as tl:
        t0 = time.perf_counter()
        sols = rx.process_stream(_blocks(items, per_block),
                                 segment_s=STREAM_SEGMENT_S, raw_format=fmt)
        wall = time.perf_counter() - t0
    signal_s = rx._abs_base / FS
    r = {"wall_s": wall, "signal_s": signal_s, "rtf": signal_s / wall,
         **_errors_3d([s.rx_ecef_m for s in sols], scen, what, min_fixes,
                      max_median_m),
         "h2d_bytes_per_signal_s": tl["h2d_bytes"] / signal_s,
         **{k: tl[k] for k in ("segments", "harvests", "overlap_share",
                               "segment_device_ms", "harvest_ms")},
         "scale": rx._ingest_scale, "channels": list(rx.channel_prn),
         "nmax": rx.trk.cfg.epoch_samples_max, "sols": sols,
         "first_fix_s": sols[0].rx_time_tow_s - scen.t0_tow}
    if sock is not None:
        r["datagrams"] = _datagrams(sock)
        if r["datagrams"] != r["fixes"]:
            raise AssertionError(f"{what}: {r['datagrams']} PVT datagrams "
                                 f"for {r['fixes']} fixes")
    return r


def _unpack_ms(fn, n=20):
    """The unpack's time for one segment: CUDA events around n calls, and
    the profiler's device time beside it (None where the profiler's trace
    lost the kernels)."""
    try:
        prof = _device_ms(fn, n)
    except NoKernelEvent:
        prof = None
    return {"unpack_ms": _time_cuda(fn, n), "unpack_ms_profiler": prof}


def phase_stream(dev, cc, tc, gb, scen, ishort_path, e2e):
    """Phase 28: phase 6's ishort file (phase 5's capture as int16 I/Q) as
    raw blocks through process_stream on the card, the PVT monitor on:
    MIN_FIXES_STREAM fixes at a median 3D error under 5 m, process()'s
    fixes over the stream's span at the same epochs (_same_epochs),
    datagrams == fixes, launches == chunks, the bytes staged to the card
    per signal second, the unpack's device time for one segment, the
    overlap share; then the same capture nibble-packed to 2 bits
    (tests/test_streaming.py's packing and bar) and the ishort stream on
    the gather correlator (launches == segments, the ishort stream's
    bars)."""
    from gnss_sdr_1_tpu_torch.runtime.stream import unpack_raw

    raw = np.fromfile(ishort_path, dtype=np.int16)
    with _counting(cc, tc) as counter:
        ish = _stream_run(dev, raw, "ishort", scen, "stream ishort",
                          MIN_FIXES_STREAM, 5.0, pvt_monitor=True)
    _check_launches(cc, tc, counter["chunks"], "stream ishort")
    ish.update(_same_epochs(ish.pop("sols"), e2e, "stream ishort",
                            MIN_SHARE_SAME_EPOCHS))
    if counter["calls"] != ish["segments"]:
        raise AssertionError(f"stream ishort: {counter['calls']} capture "
                             f"calls for {ish['segments']} segments")
    ish.update(launches_chunk_corr=cc.launches,
               launches_track_chain=tc.launches, chunks=counter["chunks"])
    # the unpack of one segment's items (span + epoch_samples_max samples)
    seg_n = int(round(FS * STREAM_SEGMENT_S)) + ish["nmax"]
    seg = torch.as_tensor(raw[:2 * seg_n], device=dev)
    ish.update(_unpack_ms(lambda: unpack_raw(seg, "ishort", ish["scale"])))
    del seg

    # 2 bits: tests/test_streaming.py's quantisation, made on the card
    x = torch.as_tensor(raw, device=dev).view(-1, 2).to(torch.float32)
    q = torch.clamp(torch.round(x * (0.7 / x[:, 0].std())), -2, 1).to(
        torch.int64)
    nibs = (q[:, 0] & 3) | ((q[:, 1] & 3) << 2)
    n2 = nibs.numel() // 2 * 2
    packed = ((nibs[0:n2:2] << 4) | nibs[1:n2:2]).to(torch.uint8).cpu(
        ).numpy()
    del x, q, nibs
    with _counting(cc, tc) as counter:
        two = _stream_run(dev, packed, "2bits_cpx", scen, "stream 2 bits",
                          MIN_FIXES_2BIT, MAX_MEDIAN_2BIT)
    _check_launches(cc, tc, counter["chunks"], "stream 2 bits")
    two.pop("sols")
    two.update(launches_chunk_corr=cc.launches,
               launches_track_chain=tc.launches, chunks=counter["chunks"])
    seg = torch.as_tensor(packed[:(seg_n + 1) // 2], device=dev)
    two.update(_unpack_ms(lambda: unpack_raw(seg, "2bits_cpx",
                                             two["scale"])))
    del packed, seg

    with _gather_counting(gb) as c:
        gat = _stream_run(dev, raw, "ishort", scen, "stream gather",
                          MIN_FIXES_STREAM, 5.0, correlator="gather")
    _check_gather_launches(gb, c, "stream gather")
    gat.pop("sols")
    if gb.launches != gat["segments"]:
        raise AssertionError(f"stream gather: {gb.launches} gather_block "
                             f"launches for {gat['segments']} segments")
    gat.update(launches_gather_block=gb.launches,
               device_us_per_epoch=c["device_us_per_epoch"])
    return {"ishort": ish, "2bits_cpx": two, "gather": gat}


def phase_rtl_tcp(dev, cc, tc, scen, ishort_path):
    """Phase 29: phase 5's capture as unsigned 8-bit I/Q (RTL_SCALE counts
    a unit, centred on 127.5) served over the rtl_tcp protocol from a
    thread on 127.0.0.1 (tests/test_io_sources.py's mock server), read by
    io.network.RtlTcpSignalSource in STREAM_BLOCK_S blocks into
    process_stream on the card: launches == chunks, MIN_FIXES_STREAM
    fixes at a median 3D error under 5 m."""
    from gnss_sdr_1_tpu_torch.io import RtlTcpSignalSource

    x = torch.as_tensor(np.fromfile(ishort_path, dtype=np.int16),
                        device=dev).to(torch.float32)
    u8 = torch.clamp(torch.round(x * (RTL_SCALE / ISHORT_SCALE) + 127.5),
                     0, 255).to(torch.uint8).cpu().numpy()
    del x
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cmds = []

    def serve():
        conn, _ = srv.accept()
        with conn:
            conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
            got = b""
            while len(got) < 15:        # sample rate, frequency, AGC
                got += conn.recv(15 - len(got))
            cmds.extend(struct.unpack(">BI", got[k:k + 5])
                        for k in range(0, 15, 5))
            conn.sendall(memoryview(u8))

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    src = RtlTcpSignalSource(port=srv.getsockname()[1],
                             frequency_hz=1575.42e6, sample_rate_hz=FS)
    per_block = int(FS * STREAM_BLOCK_S)
    n_blocks = len(u8) // 2 // per_block

    def blocks():
        for k in range(n_blocks):
            yield k * per_block, src.read(per_block)

    from gnss_sdr_1_tpu_torch.runtime import Receiver

    rx = Receiver(_e2e_config(), device=dev)
    try:
        with _counting(cc, tc) as counter:
            t0 = time.perf_counter()
            sols = rx.process_stream(blocks(), segment_s=STREAM_SEGMENT_S)
            wall = time.perf_counter() - t0
    finally:
        src.close()
        thread.join(timeout=30)
        srv.close()
    _check_launches(cc, tc, counter["chunks"], "rtl_tcp")
    signal_s = rx._abs_base / FS
    return {"wall_s": wall, "signal_s": signal_s, "rtf": signal_s / wall,
            "commands": cmds,
            **_errors_3d([s.rx_ecef_m for s in sols], scen, "rtl_tcp",
                         MIN_FIXES_STREAM),
            "first_fix_s": sols[0].rx_time_tow_s - scen.t0_tow,
            "launches_chunk_corr": cc.launches,
            "launches_track_chain": tc.launches, "chunks": counter["chunks"]}


def _state_leaves(st):
    """(name, array) for every array of a state_to_numpy dict."""
    return [(name, a) for name, v in sorted(st.items())
            for a in (v if isinstance(v, tuple) else (v,))]


def phase_checkpoint(dev, cc, tc, scen, x, e2e):
    """Phase 30: phase 5's receiver over the first CKPT_SPLIT_S of phase
    5's capture, checkpoint, resume_from on the card, the rest: the
    resumed receiver holds the checkpointed one's clock, assignments and
    tracking state; >= 30 fixes, the mean of the last 10 within 1 m of
    phase 5's uninterrupted run's.  The same file resumes on the CPU with
    the same tracking state."""
    from gnss_sdr_1_tpu_torch.runtime import Receiver
    from gnss_sdr_1_tpu_torch.track.engine import state_to_numpy

    ck = CACHE / "receiver.ckpt"
    CACHE.mkdir(exist_ok=True)
    with _counting(cc, tc) as counter:
        rx1 = Receiver(_e2e_config(), device=dev)
        t0 = time.perf_counter()
        rx1.process(x[:int(FS * CKPT_SPLIT_S)])
        first_s = time.perf_counter() - t0
        consumed = rx1._abs_base
        t0 = time.perf_counter()
        rx1.checkpoint(str(ck))
        ckpt_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rx2 = Receiver.resume_from(str(ck), device=dev)
        resume_s = time.perf_counter() - t0
        on_cpu = Receiver.resume_from(str(ck), device="cpu")
        leaves = [_state_leaves(state_to_numpy(r.state))
                  for r in (rx1, rx2, on_cpu)]
        for (name, a), (_, b), (_, c) in zip(*leaves):
            if not (np.array_equal(a, b) and np.array_equal(a, c)):
                raise AssertionError(f"checkpoint: {name} not resumed")
        if (rx2.device != dev or rx2._abs_base != consumed
                or rx2.channel_prn != rx1.channel_prn):
            raise AssertionError("checkpoint: the resumed receiver differs")
        t0 = time.perf_counter()
        sols = rx2.process(x[consumed:])
        rest_s = time.perf_counter() - t0
    _check_launches(cc, tc, counter["chunks"], "checkpoint")
    if len(sols) < MIN_FIXES_CKPT:
        raise AssertionError(f"checkpoint: {len(sols)} fixes")
    d = float(np.linalg.norm(np.mean([s.rx_ecef_m for s in sols[-10:]],
                                     axis=0)
                               - np.asarray(e2e["last10_mean_ecef"])))
    if not d < MAX_CKPT_DIFF_M:
        raise AssertionError(f"checkpoint: the last 10 fixes' mean is "
                             f"{d:.3f} m from phase 5's")
    size = ck.stat().st_size
    ck.unlink()
    return {"split_s": consumed / FS, "fixes": len(sols),
            "last10_diff_m": d, "ckpt_bytes": size, "ckpt_s": ckpt_s,
            "resume_s": resume_s, "first_s": first_s, "rest_s": rest_s,
            "launches_chunk_corr": cc.launches,
            "launches_track_chain": tc.launches, "chunks": counter["chunks"]}


# ---------------------------------------------------------------------------
# phase 9: the acquisition strategies, card against CPU
# ---------------------------------------------------------------------------


def _acq_pair(dev, cfg, head, n_calls=3):
    """One strategy's acquisition, built by the Receiver from `cfg`, on the
    card and on the CPU over `head`: (the card's result, the CPU's,
    samples per code, the strategy the receiver ran, the card's ms per
    call)."""
    from gnss_sdr_1_tpu_torch.runtime import Receiver

    def run(rx):
        if rx._acq_tong:
            return rx.acq.acquire_tong(head, tong_init=cfg.tong_init,
                                       tong_max=cfg.tong_max)
        return rx.acq.acquire(head)

    rx = Receiver(cfg, device=dev)
    res = run(rx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        run(rx)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_calls * 1e3
    ref = run(Receiver(cfg, device="cpu"))
    return res, ref, rx.samples_per_code, rx.acq_strategy, ms


def _hold_acq(what, res, ref, spc, doppler_atol=0.0):
    """The acquisition bar (ROADMAP.md): the same detections, the same
    Doppler bins (fine-Doppler: within `doppler_atol`, one fine bin),
    delays within 1 sample (circular), statistics within 1e-4 relative."""
    if not np.array_equal(res.positive, ref.positive):
        raise AssertionError(f"{what}: detections differ from the CPU: "
                             f"{res.positive} vs {ref.positive}")
    dd_f = np.abs(np.ravel(res.doppler_hz) - np.ravel(ref.doppler_hz))
    if not (dd_f <= doppler_atol).all():
        raise AssertionError(f"{what}: Doppler differs from the CPU: "
                             f"{res.doppler_hz} vs {ref.doppler_hz}")
    dd = np.abs(np.ravel(res.delay_samples) - np.ravel(ref.delay_samples))
    dd = np.minimum(dd % spc, spc - dd % spc)
    if not (dd <= 1.0).all():
        raise AssertionError(f"{what}: delays differ from the CPU by {dd}")
    rel = np.abs(res.test_stat - ref.test_stat) / np.maximum(
        np.abs(ref.test_stat), 1e-30)
    if not (rel <= 1e-4).all():
        raise AssertionError(f"{what}: statistics differ from the CPU by "
                             f"{rel}")
    return {"detected": int(np.sum(res.positive)),
            "max_delay_diff": float(dd.max()),
            "max_doppler_diff": float(dd_f.max()),
            "max_stat_rel": float(rel.max())}


def phase_acq_variants(dev, e1_head, gps_head):
    """Every acquisition strategy the receivers dispatch, card against CPU:
    on Galileo E1 (phase 10's configuration) PCPS with its two-period
    window, QuickSync, CCCWSR, 8 ms and Tong; on GPS L1 C/A (phase 3's
    PRNs at 4.092 Msps) Tong, fine-Doppler and QuickSync; and the E5a CAF
    core on a seeded random input (no E5a receiver is ported yet)."""
    from gnss_sdr_1_tpu_torch.runtime import ReceiverConfig

    rows = []
    runs = [("E1 " + s, _e1_config(
        acq_strategy=s, acq_threshold=E1_THRESHOLDS.get(s, 2.0)), e1_head)
        for s in ("pcps", "quicksync", "cccwsr", "8ms", "tong")]
    runs += [("GPS " + s, ReceiverConfig(
        fs_hz=FS, n_channels=12, prn_search=tuple(range(1, 13)),
        acq_strategy=s), gps_head)
        for s in ("tong", "fine_doppler", "quicksync")]
    for what, cfg, head in runs:
        res, ref, spc, strat, ms = _acq_pair(dev, cfg, head)
        if strat != cfg.acq_strategy:
            raise AssertionError(f"{what}: the receiver ran {strat}")
        # fine-Doppler refines on a zero-padded FFT: one bin of it
        atol = (cfg.fs_hz / (10 * spc * 8)) if strat == "fine_doppler" \
            else 0.0
        rep = _hold_acq(what, res, ref, spc, atol)
        if rep["detected"] < 6:
            raise AssertionError(f"{what}: {rep['detected']} detections")
        rows.append({"what": what, "ms_per_call": ms, **rep})
    rows.append(_caf_check(dev))
    return rows


def _caf_check(dev):
    """The E5a noncoherent I/Q CAF acquisition at an E5a-like shape (1 ms
    of 10.23 Mcps I and Q codes at 20.46 Msps, 4 PRNs, a 2 kHz CAF window)
    on a seeded random capture holding two of them: card against CPU."""
    from gnss_sdr_1_tpu_torch.acquire import AcqConfig, CafAcquisition
    from gnss_sdr_1_tpu_torch.codes import resample_code

    fs, spc = 20.46e6, 20460
    rng = np.random.default_rng(11)
    chips = {p: (rng.choice([-1.0, 1.0], 10230), rng.choice([-1.0, 1.0],
                                                            10230))
             for p in (5, 9, 13, 21)}
    di = {p: resample_code(c[0].astype(np.float32), fs, 10.23e6, spc)
          for p, c in chips.items()}
    dq = {p: resample_code(c[1].astype(np.float32), fs, 10.23e6, spc)
          for p, c in chips.items()}
    n = np.arange(2 * spc)
    x = rng.normal(size=2 * spc) + 1j * rng.normal(size=2 * spc)
    for p, delay, dop in ((5, 7001, 1320.0), (13, 15003, -2875.0)):
        comp = np.tile(np.roll(di[p], delay) + 1j * np.roll(dq[p], delay), 2)
        x = x + 0.5 * comp * np.exp(2j * np.pi * dop * n / fs)
    x = x.astype(np.complex64)
    cfg = AcqConfig(fs_hz=fs, samples_per_code=spc, samples_per_chip=2,
                    doppler_max_hz=5000.0, doppler_step_hz=250.0,
                    use_cfar=True, pfa=0.001)
    accs = [CafAcquisition(cfg, di, dq, caf_window_hz=2000.0, device=d)
            for d in (dev, "cpu")]
    res = accs[0].acquire(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        accs[0].acquire(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    rep = _hold_acq("CAF", res, accs[1].acquire(x), spc)
    if rep["detected"] < 2:
        raise AssertionError(f"CAF: {rep['detected']} detections")
    return {"what": "E5a-like CAF", "ms_per_call": ms, **rep}


# ---------------------------------------------------------------------------
# phases 10-11: the Galileo E1B receiver and CLI
# ---------------------------------------------------------------------------


def e1_capture(dev):
    """Phase 10's scenario: 8 Galileo E1B satellites, 30 s at 4.0 Msps,
    48 dB-Hz, I/NAV pages cycling words 5,1,2,3,4, made on the card with
    the numpy generator's noise (seed 1234), as engine_capture.  Returns
    (scenario, samples, seconds spent making them)."""
    return (_cells()["E1"][0],
            *card_capture(dev, ["E1"], 1234, numpy_noise=True))


def phase_e1(dev, cc, tc, scen, x):
    from gnss_sdr_1_tpu_torch.runtime import Receiver

    rx = Receiver(_e1_config(), device=dev)
    rx.preload(x)
    with _counting(cc, tc) as counter:
        t0 = time.perf_counter()
        sols = rx.process(x)
        wall = time.perf_counter() - t0
    _check_launches(cc, tc, counter["chunks"], "E1 e2e")
    if rx.trk.chain_spec.K != 5:
        raise AssertionError("E1 e2e: the chain does not run 5 taps")
    eph_err = {p: abs(d.ephemeris.sqrt_a - scen.ephemerides[p].sqrt_a)
               for p, d in rx.decoders.items() if d.ephemeris_complete}
    if len(eph_err) < MIN_EPH_E1 or max(eph_err.values()) > 2e-5:
        raise AssertionError(f"E1 e2e: ephemerides {eph_err}")
    return {"rtf": E1_S / wall, "wall_s": wall,
            **_errors_3d([s.rx_ecef_m for s in sols], scen, "E1 e2e",
                         MIN_FIXES_E1),
            "ephemerides": len(eph_err),
            "max_sqrt_a_err": max(eph_err.values()),
            "launches_chunk_corr": cc.launches,
            "launches_track_chain": tc.launches,
            "chunks": counter["chunks"], "channels": list(rx.channel_prn)}


def phase_e1_kf(dev, kb, scen, x):
    """Phase 22: the Galileo E1B receiver with the KF tracker (the virtual
    half-chip basis) on phase 10's capture, preloaded: every channel held
    to the end within E1_KF_MAX_DOPPLER_ERR of the truth Doppler, I/NAV
    ephemerides and fixes at phase 10's bars, the median 3D error under
    E1_KF_MAX_MEDIAN_M, one kf_block launch per engine call."""
    from gnss_sdr_1_tpu_torch.runtime import Receiver

    rx = Receiver(_e1_config(track_engine="kf"), device=dev)
    if rx.trk.cfg.code_length_chips != 2 * 4092:
        raise AssertionError("E1 KF: the engine is not in the virtual basis")
    rx.preload(x)
    with _kf_counting(kb) as kc:
        t0 = time.perf_counter()
        sols = rx.process(x)
        wall = time.perf_counter() - t0
    _check_kf_launches(kb, kc, "E1 KF")
    active = rx.state.active.cpu().numpy()
    dopp = rx.state.x[:, 1].cpu().numpy()
    truth = {s.prn: s.doppler_hz + s.doppler_rate_hz_s * E1_S
             + 0.5 * s.doppler_rate2_hz_s2 * E1_S ** 2 for s in scen.sats}
    err = {p: float(dopp[ch] - truth[p])
           for ch, p in enumerate(rx.channel_prn) if p is not None}
    held = sorted(p for ch, p in enumerate(rx.channel_prn)
                  if p is not None and active[ch])
    if held != sorted(E1_PRNS) or not all(
            abs(v) <= E1_KF_MAX_DOPPLER_ERR for v in err.values()):
        raise AssertionError(f"E1 KF: channels held {held}, Doppler errors "
                             f"{err}")
    eph_err = {p: abs(d.ephemeris.sqrt_a - scen.ephemerides[p].sqrt_a)
               for p, d in rx.decoders.items() if d.ephemeris_complete}
    if len(eph_err) < MIN_EPH_E1 or max(eph_err.values()) > 2e-5:
        raise AssertionError(f"E1 KF: ephemerides {eph_err}")
    return {"rtf": E1_S / wall, "wall_s": wall,
            **_errors_3d([s.rx_ecef_m for s in sols], scen, "E1 KF",
                         MIN_FIXES_E1, E1_KF_MAX_MEDIAN_M),
            "held": len(held), "doppler_err_hz": err,
            "ephemerides": len(eph_err),
            "max_sqrt_a_err": max(eph_err.values()),
            "launches_kf_block": kb.launches, "kf_calls": kc["calls"],
            "kf_blocks": kc["blocks"], "kf_epochs": kc["epochs"],
            "kf_device_us_per_epoch": kc["kf_device_us_per_epoch"],
            "launches_per_block": kb.launches / kc["blocks"]}


def phase_cli_galileo(cc, tc, scen, capture):
    """Both Galileo E1 confs through the CLI on phase 10's capture."""
    reps = {}
    runs = (("galileo_e1_gr_complex.conf",
             ["--fs", f"{FS_E1:.0f}", "--channels", str(len(E1_PRNS))]),
            ("galileo_e1_quicksync.conf", []))
    for name, extra in runs:
        what = f"CLI {name}"
        with _counting(cc, tc) as counter:
            rep = _run_cli(["-c", str(ROOT / "conf" / name), "--signal_file",
                            str(capture)] + extra, scen,
                           CACHE / f"cli_{name[:-5]}", MIN_FIXES_E1, what)
        reps[name] = _cli_launches(cc, tc, rep, counter, what)
    return reps


# ---------------------------------------------------------------------------
# phases 12-14: the GPS L5 and Galileo E5a receivers and CLI
# ---------------------------------------------------------------------------

# signal -> (sampling rate, seconds, PRNs) of phases 12-14
_SEC_CELLS = {"L5": (FS_L5, L5_S, L5_PRNS), "5X": (FS_E5A, E5A_S, E5A_PRNS)}
_BDS_CELLS = {"B1": (FS_B1I, B1I_S, B1I_PRNS), "B3": (FS_B3I, B3I_S, B3I_PRNS)}


def _shape_keys(sec, which):
    """The L5, E5a, B1I, B3I, GLONASS and L2C shapes' times and bound of
    one kernel, for the kernels line."""
    out = {}
    for sig, r in sec.items():
        k = {"L5": "l5", "5X": "e5a", "B1": "b1i", "B3": "b3i", "1G": "glo",
             "2S": "l2c"}[sig]
        t = r[which]
        out.update({f"{k}_ms": t["ms"], f"{k}_bound_ms": t["bound_ms"],
                    f"{k}_plain_ms": t["plain_ms"],
                    f"{k}_library_ms": t.get("library_ms")})
        if "bound_tf32_ms" in t:
            out[f"{k}_bound_tf32_ms"] = t["bound_tf32_ms"]
    return out


def generate_on_card(spec, sats, codes_by_prn, fs_hz, duration_s, dev,
                     noise=True, seed=1234, block_s=GEN_BLOCK_S,
                     numpy_noise=False, cn0_amplitude=None):
    """The port's siggen.generate_baseband computed on the card: the same
    signal model and the same float64 phase and code index, evaluated in
    blocks of `block_s` seconds, with unit-variance complex noise from a
    seeded torch.Generator on the card, or (`numpy_noise`) numpy's own
    normals of generate_baseband(..., seed=seed), drawn on the host and
    copied block by block, so that the capture is numpy's to within
    float32 rounding.  Each satellite's amplitude follows its C/N0 against
    that noise, or is 1 without noise, as numpy's (`cn0_amplitude` True:
    the C/N0 amplitude without the noise, for a signal added to another
    capture's noise).  Returns the capture as a complex64 tensor on
    `dev`."""
    n = int(round(fs_hz * duration_s))
    out = torch.empty(n, dtype=torch.complex64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if noise and numpy_noise:
        rng = np.random.default_rng(seed)
        host_re, host_im = rng.standard_normal(n), rng.standard_normal(n)
    two_pi = 2.0 * np.pi
    fc = spec.carrier_freq_hz
    sat_data = []
    for sat in sats:
        code = torch.as_tensor(np.asarray(codes_by_prn[sat.prn], np.float64),
                               device=dev)
        bits = None if sat.nav_bits is None else torch.as_tensor(
            np.asarray(sat.nav_bits, np.float64), device=dev)
        chips_per_bit = spec.code_rate_chips_s / (
            sat.bit_rate_override_bps or spec.bit_rate_bps)
        amp = np.sqrt(10.0 ** (sat.cn0_dbhz / 10.0) / fs_hz) \
            if (noise if cn0_amplitude is None else cn0_amplitude) else 1.0
        sat_data.append((sat, code, bits, chips_per_bit, amp))
    step = max(1, int(fs_hz * block_s))
    for a in range(0, n, step):
        m = min(step, n - a)
        t = torch.arange(a, a + m, dtype=torch.float64, device=dev) / fs_hz
        re = torch.zeros(m, dtype=torch.float64, device=dev)
        im = torch.zeros(m, dtype=torch.float64, device=dev)
        for sat, code, bits, chips_per_bit, amp in sat_data:
            dil = (sat.doppler_hz * t + 0.5 * sat.doppler_rate_hz_s * t * t
                   + sat.doppler_rate2_hz_s2 * t * t * t / 6.0) / fc
            chips = spec.code_rate_chips_s * (t + dil) - sat.delay_chips
            c = code[torch.remainder(torch.floor(chips).long(),
                                     code.shape[0])]
            if bits is not None:
                bit_idx = torch.floor(chips / chips_per_bit).long()
                d = bits[bit_idx.clamp(0, bits.shape[0] - 1)]
                c = c * torch.where(bit_idx < 0, torch.ones_like(d), d)
            env = (amp * c).float()
            phase = (two_pi * ((sat.doppler_hz + sat.carrier_offset_hz) * t
                               + 0.5 * sat.doppler_rate_hz_s * t * t
                               + sat.doppler_rate2_hz_s2 * t * t * t / 6.0)
                     + sat.phase_rad)
            ph32 = torch.remainder(phase, two_pi).float()
            re += env * torch.cos(ph32)
            im += env * torch.sin(ph32)
        if noise and numpy_noise:
            re += torch.as_tensor(host_re[a:a + m], device=dev) \
                * np.sqrt(0.5)
            im += torch.as_tensor(host_im[a:a + m], device=dev) \
                * np.sqrt(0.5)
        elif noise:
            w = torch.randn((m, 2), generator=gen, dtype=torch.float64,
                            device=dev) * np.sqrt(0.5)
            re += w[:, 0]
            im += w[:, 1]
        out[a:a + m] = torch.complex(re.float(), im.float())
    return out


def _sec_scenario(signal):
    """Phase 12 / 13's scenario, generation spec and replicas."""
    import dataclasses

    from gnss_sdr_1_tpu_torch.codes import tracking_replica
    from gnss_sdr_1_tpu_torch.constants import SIGNALS
    from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
    from gnss_sdr_1_tpu_torch.siggen.scenario import build_scenario

    _, dur, prns = _SEC_CELLS[signal]
    spec = SIGNALS[signal]
    rx_ecef = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    scen = build_scenario(rx_ecef, list(prns), t0_tow=345601.25,
                          duration_s=dur, cn0_dbhz=48.0, chip_rate=10.23e6,
                          carrier_freq=spec.carrier_freq_hz, signal=signal)
    codes = {p: tracking_replica(signal, p)[0] for p in prns}
    return scen, dataclasses.replace(spec, bit_rate_bps=1000.0), codes


def _bds_scenario(signal, prns=None, dur=None):
    """Phase 19 / 21's scenario: tests/test_system_beidou.py's D1
    constellation at 48 dB-Hz (B3I: the same D1 stream and CGCS2000 orbits
    at B3I's chip rate and carrier), each 50 bps bit repeated 20 times
    under NH20 as one 1 kbps stream; with the generation spec and the
    replicas.  `prns` and `dur` replace the cell's (phase 25: the test's
    own 5 satellites over its 24 s)."""
    import dataclasses

    from gnss_sdr_1_tpu_torch.codes import BEIDOU_NH20, tracking_replica
    from gnss_sdr_1_tpu_torch.constants import SIGNALS
    from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
    from gnss_sdr_1_tpu_torch.siggen.scenario import build_scenario

    _, cell_dur, cell_prns = _BDS_CELLS[signal]
    prns, dur = prns or cell_prns, dur or cell_dur
    spec = SIGNALS[signal]
    rx_ecef = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    scen = build_scenario(rx_ecef, list(prns), t0_tow=345601.25,
                          duration_s=dur, cn0_dbhz=48.0,
                          chip_rate=spec.code_rate_chips_s,
                          carrier_freq=spec.carrier_freq_hz, signal="B1")
    nh = np.asarray(BEIDOU_NH20, np.float64)
    for s in scen.sats:
        s.nav_bits = np.repeat(s.nav_bits, 20) * np.tile(nh, len(s.nav_bits))
    codes = {p: tracking_replica(signal, p)[0] for p in prns}
    return scen, dataclasses.replace(spec, bit_rate_bps=1000.0), codes


def check_card_generator(dev, check_s=0.02, block_s=0.007):
    """The generator on the card against the port's numpy generator on a
    noiseless stretch of every capture the script makes on the card, and
    with the numpy noise on the captures that take it (blocks shorter than
    the stretch, so block seams are inside it): within 1e-5 of the unit
    amplitude."""
    from gnss_sdr_1_tpu_torch.siggen import generate_baseband

    err = {}
    checks = [(name, False) for name in _cells()] + [
        (name, True) for name in NUMPY_NOISE_CELLS]
    for name, noisy in checks:
        _, spec, sats, codes, fs, _ = _cells()[name]
        got = generate_on_card(spec, sats, codes, fs, check_s, dev,
                               noise=noisy, block_s=block_s,
                               numpy_noise=noisy).cpu().numpy()
        want = generate_baseband(spec, sats, codes, fs, check_s,
                                 noise=noisy)
        if got.shape != want.shape:
            raise AssertionError(f"generator shapes {got.shape} {want.shape}")
        key = name + (" with noise" if noisy else "")
        err[key] = float(np.abs(got - want).max())
        if not err[key] <= 1e-5:
            raise AssertionError(f"{key}: the generator on the card differs "
                                 f"from numpy by {err[key]:.3e}")
    return {"err": err, "s": check_s, "block_s": block_s}


@functools.lru_cache(maxsize=1)
def _cells():
    """Every capture the script makes on the card: name -> (scenario or
    None, generation spec, satellites, replicas by PRN, fs, seconds)."""
    import dataclasses

    from gnss_sdr_1_tpu_torch.codes import (glonass_ca_code, gps_l1ca_code,
                                            tracking_replica)
    from gnss_sdr_1_tpu_torch.constants import (FREQ_G1_GLO, GALILEO_E1B,
                                                GLONASS_L1_CA, GPS_L1_CA,
                                                GPS_L2C)
    from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
    from gnss_sdr_1_tpu_torch.siggen.scenario import (_auto_place,
                                                      build_scenario)

    rx = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    rx_glo = llh_to_ecef(np.radians(55.75), np.radians(37.62), 180.0)
    e1_spec = dataclasses.replace(GALILEO_E1B, code_rate_chips_s=2.046e6,
                                  code_length_chips=2 * 4092,
                                  bit_rate_bps=250.0)
    t0 = 345601.25

    def cell(scen, spec, signal, fs, dur):
        codes = {s.prn: (gps_l1ca_code(s.prn) if signal == "1C"
                         else glonass_ca_code() if signal == "1G"
                         else tracking_replica(signal, s.prn)[0])
                 for s in scen.sats}
        return scen, spec, scen.sats, codes, fs, dur

    def gps(prns, dur, t0_tow=t0, at=rx):
        return build_scenario(at, list(prns), t0_tow=t0_tow, duration_s=dur,
                              cn0_dbhz=47.0, subframe_cycle=(1, 2, 3))

    def glo(ks, dur):
        return build_scenario(rx_glo, sorted(ks), t0_tow=GLO_T0,
                              duration_s=dur, cn0_dbhz=47.0,
                              chip_rate=0.511e6, carrier_freq=FREQ_G1_GLO,
                              signal="1G", fdma_ks=ks)

    bench = _bench_sats(ENGINE_S)
    cells = {"engine": (None, GPS_L1_CA, bench,
                        {s.prn: gps_l1ca_code(s.prn) for s in bench}, FS,
                        ENGINE_S),
             "e2e": cell(gps(range(1, 13), E2E_S), GPS_L1_CA, "1C", FS,
                         E2E_S),
             "E1": cell(build_scenario(
                 rx, list(E1_PRNS), t0_tow=t0, duration_s=E1_S,
                 cn0_dbhz=48.0, chip_rate=2.046e6, signal="1B"),
                 e1_spec, "1B", FS_E1, E1_S)}
    for sig in ("L5", "5X", "B1", "B3"):
        scen, spec, codes = (_sec_scenario if sig in _SEC_CELLS
                             else _bds_scenario)(sig)
        fs, dur, _ = {**_SEC_CELLS, **_BDS_CELLS}[sig]
        cells[sig] = (scen, spec, scen.sats, codes, fs, dur)
    cells["1G"] = cell(glo(GLO_KS, GLO_S), GLONASS_L1_CA, "1G", FS_GLO,
                       GLO_S)
    cells["mixed 1C"] = cell(gps(MIX_GPS, MIX_S), GPS_L1_CA, "1C", FS_MIX,
                             MIX_S)
    cells["mixed 1B"] = cell(build_scenario(
        rx, list(MIX_GAL), t0_tow=t0, duration_s=MIX_S, cn0_dbhz=48.0,
        chip_rate=2.046e6, signal="1B"), e1_spec, "1B", FS_MIX, MIX_S)
    cells["dual 1C"] = cell(gps(DUAL_PRNS, DUAL_S), GPS_L1_CA, "1C",
                            FS_DUAL, DUAL_S)
    cells["dual 2S"] = cell(build_scenario(
        rx, list(DUAL_PRNS), t0_tow=t0, duration_s=DUAL_S, cn0_dbhz=47.0,
        signal="2S"), GPS_L2C, "2S", FS_DUAL, DUAL_S)
    cells["conf 1C"] = cell(gps(GLO_CONF_GPS, GLO_CONF_S, GLO_T0, rx_glo),
                            GPS_L1_CA, "1C", FS_GLO_HI, GLO_CONF_S)
    cells["conf 1G"] = cell(glo({GLO_CONF_SLOT: 0}, GLO_CONF_S),
                            GLONASS_L1_CA, "1G", FS_GLO_HI, GLO_CONF_S)
    cells["kalman"] = cell(gps(range(1, 13), E2E_S), GPS_L1_CA, "1C",
                           FS_KALMAN, E2E_S)
    cells["conf 2S"] = cell(build_scenario(
        rx, list(L2C_CONF_PRNS), t0_tow=t0, duration_s=L2C_CONF_S,
        cn0_dbhz=47.0, signal="2S"), GPS_L2C, "2S", FS_L2C, L2C_CONF_S)
    # phases 24-25: tests/test_system_galileo.py's and test_system_beidou
    # .py's 5-satellite scenarios as they stand
    cells["sys 1B"] = cell(build_scenario(
        rx, list(SYS_E1_PRNS), t0_tow=t0, duration_s=SYS_E1_S,
        cn0_dbhz=48.0, chip_rate=2.046e6, signal="1B"), e1_spec, "1B",
        FS_SYS, SYS_E1_S)
    scen, spec, codes = _bds_scenario("B1", SYS_B1_PRNS, SYS_B1_S)
    cells["sys B1"] = (scen, spec, scen.sats, codes, FS_SYS, SYS_B1_S)
    # phases 31 and 33: phase 5's scenario at 2.046 Msps, and a base
    # receiver 500 m away under the same orbits (the rover's placement)
    cells["agnss"] = cell(gps(range(1, 13), E2E_S), GPS_L1_CA, "1C",
                          FS_AGNSS, E2E_S)
    toe = np.floor(t0 / 7200.0) * 7200.0
    raans, anoms = _auto_place(rx, list(range(1, 13)), toe, t0)
    cells["base"] = cell(build_scenario(
        _offset_from(rx, RTK_BASE_EAST_M, RTK_BASE_NORTH_M),
        list(range(1, 13)), t0_tow=t0, duration_s=E2E_S, cn0_dbhz=47.0,
        subframe_cycle=(1, 2, 3), raans=raans, anomalies=anoms),
        GPS_L1_CA, "1C", FS, E2E_S)
    return cells


def card_capture(dev, names, seed, numpy_noise=False, cn0_all=False):
    """The sum of the named cells' signals made on the card (one noise
    term, from `seed`, with the first; `numpy_noise`: numpy's normals),
    copied to the host once.  The later cells come at amplitude 1, as
    tests/test_system_mixed.py adds its Galileo signal, or (`cn0_all`) at
    their own C/N0 against the first cell's noise.  Returns (samples,
    seconds spent making them)."""
    t0 = time.perf_counter()
    x = None
    for k, name in enumerate(names):
        _, spec, sats, codes, fs, dur = _cells()[name]
        part = generate_on_card(spec, sats, codes, fs, dur, dev,
                                noise=k == 0, seed=seed,
                                numpy_noise=numpy_noise,
                                cn0_amplitude=True if cn0_all else None)
        x = part if x is None else x + part
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    xh = x.cpu().numpy()
    del x
    return xh, gen_s


def sec_capture(dev, signal):
    """Phase 12 / 13's capture, made on the card and copied to the host
    once (the receiver's acquisition and the CLI's file read take host
    samples; `preload` puts it back on the card).  Returns (scenario,
    samples, seconds spent making them on the card)."""
    return (_cells()[signal][0], *card_capture(dev, [signal], 1234))


def _eph_check(rx, scen, what, pages):
    """At least MIN_EPH_SEC complete ephemerides with sqrt_a within 1e-3
    of the truth (and, on F/NAV, pages 1-4 decoded)."""
    errs = {}
    for p, d in rx.decoders.items():
        if not d.ephemeris_complete:
            continue
        if pages and not {1, 2, 3, 4} <= d.raw.pages:
            raise AssertionError(f"{what}: PRN {p} pages {d.raw.pages}")
        errs[p] = abs(d.ephemeris.sqrt_a - scen.ephemerides[p].sqrt_a)
    if len(errs) < MIN_EPH_SEC or max(errs.values()) > 1e-3:
        raise AssertionError(f"{what}: ephemerides {errs}")
    return errs


def phase_sec(dev, cc, tc, scen, x, signal):
    """Phase 12 (L5) / 13 (E5a with the CAF): the receiver over the
    preloaded capture, each kernel's launches == chunks, every chain launch
    on the secondary-code instance, and chunks run with the wipe on."""
    from gnss_sdr_1_tpu_torch.runtime import Receiver

    what = f"{signal} e2e"
    rx = Receiver(_sec_config(signal), device=dev)
    rx.preload(x)
    with _counting(cc, tc) as counter:
        t0 = time.perf_counter()
        sols = rx.process(x)
        wall = time.perf_counter() - t0
    chunks = counter["chunks"]
    _check_launches(cc, tc, chunks, what)
    spec = rx.trk.chain_spec
    key = (spec.K, spec.order, spec.sec_data, spec.sec_len)
    inst = dict(counter["instances"])
    if spec.sec_len != rx._sec_period or inst != {key: chunks}:
        raise AssertionError(f"{what}: chain instances {inst} for {chunks} "
                             f"chunks of sec_len {spec.sec_len}")
    if not counter["sec_chunks"] > 0:
        raise AssertionError(f"{what}: no chunk ran with the secondary wipe")
    eph = _eph_check(rx, scen, what, pages=signal == "5X")
    return {"rtf": _SEC_CELLS[signal][1] / wall, "wall_s": wall,
            **_errors_3d([s.rx_ecef_m for s in sols], scen, what,
                         MIN_FIXES_SEC),
            "strategy": rx.acq_strategy, "ephemerides": len(eph),
            "max_sqrt_a_err": max(eph.values()),
            "pages": ", F/NAV pages 1-4" if signal == "5X" else "",
            "launches_chunk_corr": cc.launches,
            "launches_track_chain": tc.launches, "chunks": chunks,
            "sec_chunks": counter["sec_chunks"],
            "instances": {"<" + ",".join(str(int(v)) for v in k) + ">": n
                          for k, n in inst.items()},
            "channels": list(rx.channel_prn),
            "modes": rx._mode_host.tolist()}


def _list_outputs(out_dir):
    return {p.name: p.stat().st_size for p in sorted(out_dir.iterdir())}


def phase_cli_sec(cc, tc, scen, x, signal):
    """Phase 14: the signal's conf through the CLI over the capture written
    as a gr_complex file (deleted after the runs).  The L5 conf as written;
    the E5a conf as written, which must exit 0 (its threshold, 2.0, is on
    PCPS's scale and the CAF's statistic stays ~1e-3, so nothing is
    acquired), then with the CAF's threshold and pull-in PLL."""
    from gnss_sdr_1_tpu_torch.__main__ import main as cli_main

    CACHE.mkdir(exist_ok=True)
    path = CACHE / f"{signal}_{_SEC_CELLS[signal][0]:.0f}.gr_complex"
    x.tofile(path)
    reps = {}
    try:
        if signal == "L5":
            runs = [("gps_l5.conf", ROOT / "conf" / "gps_l5.conf")]
        else:
            conf = ROOT / "conf" / "galileo_e5a.conf"
            buf = io.StringIO()
            out_dir = CACHE / "cli_galileo_e5a_as_written"
            with contextlib.redirect_stdout(buf):
                rc = cli_main(["-c", str(conf), "--signal_file", str(path),
                               "--out_dir", str(out_dir)])
            lines = buf.getvalue().splitlines()
            for ln in lines:
                log(f"    | {ln}")
            if rc != 0 or lines[-1] != "No position fix obtained.":
                raise AssertionError(f"galileo_e5a.conf as written: exit {rc}"
                                     f", last line {lines[-1]!r}")
            log("[14] CLI, galileo_e5a.conf as written: exit 0, no fix (the "
                "conf's PCPS-scale threshold 2.0 against the CAF statistic)")
            text = conf.read_text()
            for key, value in (("Acquisition_5X.threshold=", CAF_THRESHOLD),
                               ("Tracking_5X.pll_bw_hz=", CAF_PLL_BW_HZ)):
                text, n = re.subn(f"^{re.escape(key)}.*$", f"{key}{value}",
                                  text, flags=re.M)
                if n != 1:
                    raise AssertionError(f"galileo_e5a.conf has no {key}")
            caf = CACHE / "galileo_e5a_caf.conf"
            caf.write_text(text)
            runs = [("galileo_e5a.conf, CAF threshold and pull-in PLL", caf)]
        for name, conf in runs:
            what = f"CLI {name}"
            out_dir = CACHE / f"cli_{signal}"
            with _counting(cc, tc) as counter:
                rep = _run_cli(["-c", str(conf), "--signal_file", str(path)],
                               scen, out_dir, 1, what, max_median_m=None)
            reps[name] = _cli_launches(cc, tc, rep, counter, what)
            rep["outputs"] = _list_outputs(out_dir)
            log(f"[14] CLI, {name}: {rep['summary']}, median 3D error "
                f"{rep['median_3d_m']:.2f} m (no bar), outputs "
                + ", ".join(f"{k} ({v} B)" for k, v in rep["outputs"].items()))
    finally:
        path.unlink(missing_ok=True)
    return reps


# ---------------------------------------------------------------------------
# phases 19-21: BeiDou B1I and B3I receivers and bds_b1i_ibyte.conf
# ---------------------------------------------------------------------------


def _bds_bars(ephs, ecef, scen, what, system="C"):
    """tests/test_system_beidou.py's bars (tests/test_system_galileo.py's
    are the same without the system check, `system` None): at least
    MIN_EPH_BDS complete ephemerides, each of `system` with sqrt_a within
    MAX_SQRT_A_ERR_BDS of the truth; at least MIN_FIXES_BDS fixes, a median 3D error and a
    mean-bias norm under MAX_MEDIAN_BDS and MAX_BIAS_BDS.  Returns the
    numbers and the bars that failed (empty when all hold)."""
    errs = {p: abs(e.sqrt_a - scen.ephemerides[p].sqrt_a)
            for p, e in ephs.items()}
    ecef = np.asarray(ecef, np.float64).reshape(-1, 3)
    d = ecef - scen.rx_ecef
    e3d = np.linalg.norm(d, axis=1)
    rep = {"ephemerides": len(errs),
           "max_sqrt_a_err": max(errs.values(), default=float("nan")),
           "systems": sorted({getattr(e, "system", "G")
                              for e in ephs.values()}),
           "fixes": len(ecef),
           "median_3d_m": float(np.median(e3d)) if len(e3d) else np.nan,
           "bias_norm_m": float(np.linalg.norm(d.mean(axis=0)))
           if len(e3d) else np.nan}
    failed = []
    if len(errs) < MIN_EPH_BDS \
            or (system and rep["systems"] != [system]) \
            or not rep["max_sqrt_a_err"] <= MAX_SQRT_A_ERR_BDS:
        failed.append(f"ephemerides {errs} systems {rep['systems']}")
    if len(ecef) < MIN_FIXES_BDS:
        failed.append(f"{len(ecef)} fixes")
    if not (np.isfinite(e3d).all()
            and rep["median_3d_m"] < MAX_MEDIAN_BDS):
        failed.append(f"median 3D error {rep['median_3d_m']:.2f} m")
    if not rep["bias_norm_m"] < MAX_BIAS_BDS:
        failed.append(f"mean-bias norm {rep['bias_norm_m']:.2f} m")
    rep["failed"] = [f"{what}: {f}" for f in failed]
    return rep


def phase_bds(dev, cc, tc, scen, x, signal):
    """Phase 19 (B1I) / 21 (B3I): the receiver over the preloaded capture
    at tests/test_system_beidou.py's bars, each kernel's launches ==
    chunks, every chain launch on the NH20 instance, chunks run with the
    wipe on."""
    from gnss_sdr_1_tpu_torch.runtime import Receiver

    what = f"{signal} e2e"
    rx = Receiver(_bds_config(signal), device=dev)
    rx.preload(x)
    with _counting(cc, tc) as counter:
        t0 = time.perf_counter()
        sols = rx.process(x)
        wall = time.perf_counter() - t0
    chunks = counter["chunks"]
    _check_launches(cc, tc, chunks, what)
    spec = rx.trk.chain_spec
    key = (spec.K, spec.order, spec.sec_data, spec.sec_len)
    inst = dict(counter["instances"])
    if spec.sec_len != 20 or not spec.sec_data or inst != {key: chunks}:
        raise AssertionError(f"{what}: chain instances {inst} for {chunks} "
                             f"chunks of sec_len {spec.sec_len}")
    if not counter["sec_chunks"] > 0:
        raise AssertionError(f"{what}: no chunk ran with the NH20 wipe")
    ephs = {p: d.ephemeris for p, d in rx.decoders.items()
            if d.ephemeris_complete}
    rep = _bds_bars(ephs, [s.rx_ecef_m for s in sols], scen, what)
    if rep["failed"]:
        raise AssertionError("; ".join(rep["failed"]))
    return {**rep, "rtf": _BDS_CELLS[signal][1] / wall, "wall_s": wall,
            "launches_chunk_corr": cc.launches,
            "launches_track_chain": tc.launches, "chunks": chunks,
            "sec_chunks": counter["sec_chunks"],
            "segments": counter["calls"],
            "instances": {"<" + ",".join(str(int(v)) for v in k) + ">": n
                          for k, n in inst.items()},
            "channels": list(rx.channel_prn),
            "modes": rx._mode_host.tolist(),
            "nh20_sync": {p: d.sec_sync_offset
                          for p, d in rx.decoders.items()}}


def _rinex_c_rows(out_dir):
    """BeiDou ('C') satellite rows of the RINEX 3 observation file and
    records of the navigation file the CLI wrote."""
    rows = {}
    for name in ("observables.rnx", "brdc.rnx"):
        path = out_dir / name
        text = path.read_text() if path.is_file() else ""
        rows[name] = len(re.findall(r"^C\d\d ", text, flags=re.M))
    return rows


def phase_cli_bds(cc, tc, scen, x):
    """Phase 20: conf/bds_b1i_ibyte.conf as written through the CLI over
    phase 19's capture written as an ibyte file at its 5 Msps (deleted
    after the run), at phase 19's bars; the BeiDou rows of the RINEX files
    it writes."""
    from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef

    CACHE.mkdir(exist_ok=True)
    path = CACHE / "cli_bds_b1i.ibyte"
    t0 = time.perf_counter()
    _write_capture(x, path, "ibyte", IBYTE_SCALE)
    write_s = time.perf_counter() - t0
    what = "CLI bds_b1i_ibyte.conf"
    out_dir = CACHE / "cli_bds"
    rxs = []
    try:
        with _counting(cc, tc) as counter:
            rep = _run_cli(["-c", str(ROOT / "conf" / "bds_b1i_ibyte.conf"),
                            "--signal_file", str(path)], scen, out_dir,
                           MIN_FIXES_BDS, what, max_median_m=MAX_MEDIAN_BDS,
                           receivers=rxs)
    finally:
        path.unlink(missing_ok=True)
    rep = _cli_launches(cc, tc, rep, counter, what)
    (rx,) = rxs
    ephs = {p: d.ephemeris for p, d in rx.decoders.items()
            if d.ephemeris_complete}
    coords = json.loads((out_dir / "position.geojson").read_text())[
        "geometry"]["coordinates"]
    lon, lat, h = np.asarray(coords, np.float64).reshape(-1, 3).T
    bars = _bds_bars(ephs, np.stack(llh_to_ecef(
        np.radians(lat), np.radians(lon), h), -1), scen, what)
    if bars["failed"]:
        raise AssertionError("; ".join(bars["failed"]))
    rows = _rinex_c_rows(out_dir)
    if not (rows["observables.rnx"] > 0
            and rows["brdc.rnx"] == bars["ephemerides"]):
        raise AssertionError(f"{what}: RINEX C rows {rows} for "
                             f"{bars['ephemerides']} ephemerides")
    rep.update(bars, rinex_c_rows=rows, sec_chunks=counter["sec_chunks"],
               write_s=write_s)
    log(f"[20] CLI, bds_b1i_ibyte.conf as written: {rep['summary']}, "
        f"mean-bias norm {bars['bias_norm_m']:.2f} m, ephemerides "
        f"{bars['ephemerides']} (system {bars['systems']}), RINEX C rows "
        f"{rows['observables.rnx']} observation, {rows['brdc.rnx']} "
        f"navigation, {counter['sec_chunks']} chunks with the NH20 wipe "
        f"(the conf's extension is 0) | file written in {write_s:.1f} s")
    return {"bds_b1i_ibyte.conf": rep}


# ---------------------------------------------------------------------------
# phases 15-18: GLONASS FDMA, the multi-group receivers and their confs
# ---------------------------------------------------------------------------


def _glonass_config(**kw):
    """tests/test_system_glonass.py's receiver: 5 slots on their FDMA
    channels, 3 dwells, 25 Hz PLL."""
    from gnss_sdr_1_tpu_torch.runtime import ReceiverConfig

    return ReceiverConfig(**{**dict(
        fs_hz=FS_GLO, signal_id="1G", n_channels=len(GLO_KS),
        prn_search=tuple(GLO_KS), fdma_k=tuple(GLO_KS.items()),
        acq_dwells=3, pll_bw_hz=25.0, dll_bw_hz=2.0), **kw})


def phase_glonass(dev, cc, tc, scen, x):
    """Phase 15: the GLONASS L1 receiver over the preloaded capture, at
    tests/test_system_glonass.py's bars; each kernel's launches == chunks,
    all on the <3,3,false,false> instance, chunks run with a non-zero FDMA
    bias counted.  Then the same receiver with 5 s segments
    (reacq_interval_blocks=125) for what the pull-in rule (1,000 surviving
    epochs per channel) costs."""
    from gnss_sdr_1_tpu_torch.runtime import Receiver

    what = "GLONASS e2e"
    rx = Receiver(_glonass_config(), device=dev)
    rx.preload(x)
    with _counting(cc, tc) as counter:
        t0 = time.perf_counter()
        sols = rx.process(x)
        wall = time.perf_counter() - t0
    chunks = counter["chunks"]
    _check_launches(cc, tc, chunks, what)
    spec = rx.trk.chain_spec
    inst = dict(counter["instances"])
    if inst != {(3, spec.order, False, 1): chunks}:
        raise AssertionError(f"{what}: chain instances {inst}")
    if not counter["offset_chunks"] > 0:
        raise AssertionError(f"{what}: no chunk ran with an FDMA bias")
    offs = rx.state.carr_offset_hz.cpu().numpy()
    tracked = {p: n for p, n in rx.sym_count.items() if n > 10_000}
    if len(tracked) < MIN_TRACKED_GLO:
        raise AssertionError(f"{what}: tracked {rx.sym_count}")
    eph = {}
    for slot, dec in rx.decoders.items():
        if not dec.ephemeris_complete:
            continue
        g, t = dec.ephemeris, scen.ephemerides[slot]
        if not (abs(g.x_km - t.x_km) <= 1e-9 and abs(g.vz_kms - t.vz_kms)
                <= 1e-12 and g.tb_s == t.tb_s):
            raise AssertionError(f"{what}: slot {slot} ephemeris {g}")
        eph[slot] = abs(g.x_km - t.x_km)
    if len(eph) < MIN_EPH_GLO:
        raise AssertionError(f"{what}: {len(eph)} GNAV ephemerides")
    rep = {"rtf": GLO_S / wall, "wall_s": wall,
           **_errors_3d([s.rx_ecef_m for s in sols], scen, what,
                        MIN_FIXES_GLO, MAX_MEDIAN_GLO),
           "tracked": len(tracked), "ephemerides": len(eph),
           "launches_chunk_corr": cc.launches,
           "launches_track_chain": tc.launches, "chunks": chunks,
           "offset_chunks": counter["offset_chunks"],
           "segments": counter["calls"], "channels": list(rx.channel_prn),
           "offsets_hz": offs.tolist()}
    rx5 = Receiver(_glonass_config(reacq_interval_blocks=125), device=dev)
    rx5.preload(x)
    with _counting(cc, tc) as c5:
        t0 = time.perf_counter()
        sols5 = rx5.process(x)
        wall5 = time.perf_counter() - t0
    _check_launches(cc, tc, c5["chunks"], what + " (5 s segments)")
    rep["long_segments"] = {"segments": c5["calls"], "rtf": GLO_S / wall5,
                            "fixes": len(sols5)}
    return rep


def _group_counting(cc, tc):
    """Per-group launch and chunk counts of a MultiReceiver run: wraps
    Receiver.process so that each group's run is counted on its own (the
    counters of `_counting` read just before and just after it)."""
    from gnss_sdr_1_tpu_torch.runtime.receiver import Receiver

    groups, proc = [], Receiver.process

    @contextlib.contextmanager
    def ctx(counter):
        def counted(self, samples):
            before = (cc.launches, tc.launches, counter["chunks"],
                      dict(counter["instances"]))
            t0 = time.perf_counter()
            try:
                return proc(self, samples)
            finally:
                inst = {"<" + ",".join(str(int(v)) for v in k) + ">":
                        n - before[3].get(k, 0)
                        for k, n in counter["instances"].items()
                        if n - before[3].get(k, 0)}
                groups.append({
                    "signal": self.cfg.signal_id,
                    "wall_s": time.perf_counter() - t0,
                    "launches_chunk_corr": cc.launches - before[0],
                    "launches_track_chain": tc.launches - before[1],
                    "chunks": counter["chunks"] - before[2],
                    "instances": inst, "K": self.trk.chain_spec.K,
                    "fixes_alone": len(self.solutions)})

        Receiver.process = counted
        try:
            yield groups
        finally:
            Receiver.process = proc

    return ctx


def _check_groups(groups, what):
    for g in groups:
        n = g["chunks"]
        if not n > 0 or g["launches_chunk_corr"] != n or \
                g["launches_track_chain"] != n or \
                sum(g["instances"].values()) != n or \
                any(k[1] != str(g["K"]) for k in g["instances"]):
            raise AssertionError(f"{what}: group {g['signal']} launches {g}")


def _mixed_configs():
    """tests/test_system_mixed.py's groups, from its in-memory conf through
    the port's to_receiver_configs."""
    import dataclasses

    from gnss_sdr_1_tpu_torch.runtime.config import (InMemoryConfiguration,
                                                     to_receiver_configs)

    cfgs = to_receiver_configs(InMemoryConfiguration({
        "GNSS-SDR.internal_fs_sps": str(FS_MIX),
        "Channels_1C.count": str(len(MIX_GPS)),
        "Channels_1B.count": str(len(MIX_GAL)),
        "Acquisition_1C.implementation": "GPS_L1_CA_PCPS_Acquisition",
        "Acquisition_1B.implementation":
            "Galileo_E1_PCPS_Ambiguous_Acquisition",
        "Tracking_1C.implementation": "GPS_L1_CA_DLL_PLL_Tracking",
        "Tracking_1B.implementation": "Galileo_E1_DLL_PLL_VEML_Tracking",
    }))
    if [c.signal_id for c in cfgs] != ["1C", "1B"]:
        raise AssertionError(f"mixed conf groups {cfgs}")
    return [dataclasses.replace(cfgs[0], prn_search=MIX_GPS),
            dataclasses.replace(cfgs[1], prn_search=MIX_GAL, acq_dwells=3,
                                pll_bw_hz=15.0, dll_bw_hz=2.0)]


def _joint_errors(joint, rx_ecef, what, min_fixes, max_median_m=None,
                  converged_half=False):
    ecef = np.stack([j.solution.rx_ecef_m for j in joint]) if joint \
        else np.zeros((0, 3))
    if len(ecef) < min_fixes:
        raise AssertionError(f"{what}: {len(ecef)} joint fixes "
                             f"(< {min_fixes})")
    e3d = np.linalg.norm(ecef - rx_ecef, axis=1)
    med = float(np.median(e3d))
    tail = float(np.median(e3d[len(e3d) // 2:]))
    bar = tail if converged_half else med
    if not np.isfinite(e3d).all() or (max_median_m is not None
                                      and not bar < max_median_m):
        raise AssertionError(f"{what}: median 3D error {med:.2f} m "
                             f"(converged half {tail:.2f} m)")
    return {"fixes": len(ecef), "median_3d_m": med,
            "median_3d_converged_half_m": tail, "max_3d_m": float(e3d.max())}


def phase_mixed(dev, cc, tc, x):
    """Phase 16: GPS L1 C/A + Galileo E1B groups on one stream with one
    joint PVT (an inter-system-bias column for Galileo's 3 satellites), at
    tests/test_system_mixed.py's bars; per group, launches == chunks on
    its own chain instance (K=3, then K=5)."""
    from gnss_sdr_1_tpu_torch.runtime.multi_receiver import MultiReceiver

    what = "mixed e2e"
    scen_e = _cells()["mixed 1B"][0]
    mrx = MultiReceiver(_mixed_configs(), device=dev)
    with _counting(cc, tc) as counter, \
            _group_counting(cc, tc)(counter) as groups:
        t0 = time.perf_counter()
        joint = mrx.process(x)
        wall = time.perf_counter() - t0
    _check_groups(groups, what)
    if [g["K"] for g in groups] != [3, 5]:
        raise AssertionError(f"{what}: groups {groups}")
    if mrx.receivers[1].solutions:
        raise AssertionError(f"{what}: the Galileo group fixed alone")
    for j in joint:
        ps = j.per_system_prns
        if set(ps) != {"G", "E"} or len(ps["G"]) < 3 or len(ps["E"]) < 2:
            raise AssertionError(f"{what}: a fix with {ps}")
    eph = {p: abs(d.ephemeris.sqrt_a - scen_e.ephemerides[p].sqrt_a)
           for p, d in mrx.receivers[1].decoders.items()
           if d.ephemeris_complete}
    n_gps = sum(d.ephemeris_complete
                for d in mrx.receivers[0].decoders.values())
    if len(eph) < 2 or max(eph.values()) > 2e-5 or n_gps < 3:
        raise AssertionError(f"{what}: ephemerides GPS {n_gps}, E1 {eph}")
    return {"rtf": MIX_S / wall, "wall_s": wall,
            **_joint_errors(joint, scen_e.rx_ecef, what, MIN_FIXES_MIX,
                            MAX_MEDIAN_MIX),
            "groups": groups, "ephemerides_e1": len(eph),
            "ephemerides_gps": n_gps,
            "launches_chunk_corr": cc.launches,
            "launches_track_chain": tc.launches,
            "chunks": counter["chunks"]}


def phase_dual(dev, cc, tc, x1, x2):
    """Phase 17: GPS L1 + L2C groups on two streams (the same satellites
    on two bands, a clock column per group), at tests/test_system_mixed.py's
    dual-band bars; per group, launches == chunks."""
    from gnss_sdr_1_tpu_torch.runtime import ReceiverConfig
    from gnss_sdr_1_tpu_torch.runtime.multi_receiver import MultiReceiver
    from gnss_sdr_1_tpu_torch.telemetry.channel_adapters import \
        GpsL2ChannelDecoder

    what = "dual-band e2e"
    scen = _cells()["dual 2S"][0]
    cfg1 = ReceiverConfig(fs_hz=FS_DUAL, signal_id="1C", n_channels=4,
                          prn_search=DUAL_PRNS,
                          carrier_smoothing_epochs=200)
    mrx = MultiReceiver([cfg1, _l2c_config(carrier_smoothing_epochs=200)],
                        device=dev)
    with _counting(cc, tc) as counter, \
            _group_counting(cc, tc)(counter) as groups:
        t0 = time.perf_counter()
        joint = mrx.process([x1, x2])
        wall = time.perf_counter() - t0
    _check_groups(groups, what)
    rx2 = mrx.receivers[1]
    if not all(isinstance(d, GpsL2ChannelDecoder)
               for d in rx2.decoders.values()):
        raise AssertionError(f"{what}: L2 decoders {rx2.decoders}")
    n2 = sum(d.ephemeris_complete for d in rx2.decoders.values())
    if n2 < MIN_EPH_L2C:
        raise AssertionError(f"{what}: {n2} CNAV ephemerides")
    rep = _joint_errors(joint, scen.rx_ecef, what, 10, 5.0,
                        converged_half=True)
    if not rep["median_3d_m"] < 20.0:
        raise AssertionError(f"{what}: median 3D {rep['median_3d_m']:.2f} m")
    if not any(len(j.per_system_prns.get("G", [])) > 4 for j in joint):
        raise AssertionError(f"{what}: no fix with the L2 band")
    return {"rtf": DUAL_S / wall, "wall_s": wall, **rep,
            "cnav_ephemerides": n2, "groups": groups,
            "launches_chunk_corr": cc.launches,
            "launches_track_chain": tc.launches,
            "chunks": counter["chunks"]}


def _l2c_config(**kw):
    """The L2C group of tests/test_system_mixed.py's dual-band case: a
    ~1/(2T) Doppler grid for the 20 ms coherent window and a 4 Hz second
    step that keeps the handoff inside the 4 Hz PLL's pull-in range."""
    from gnss_sdr_1_tpu_torch.runtime import ReceiverConfig

    return ReceiverConfig(**{**dict(
        fs_hz=FS_DUAL, signal_id="2S", n_channels=4, prn_search=DUAL_PRNS,
        pll_bw_hz=4.0, dll_bw_hz=0.4, doppler_max_hz=3000.0,
        doppler_step_hz=50.0, acq_threshold=1.6, doppler_step2_hz=4.0,
        num_doppler_bins_step2=50), **kw})


def _l2c_segments(dev, cc, tc, x):
    """What the pull-in rule costs the L2CM group alone (it counts 1,000
    symbols, 20 s of 20 ms epochs): segments and RTF at the default 1 s
    segments and at 5 s (reacq_interval_blocks=125)."""
    from gnss_sdr_1_tpu_torch.runtime import Receiver

    out = {}
    for blocks in (25, 125):
        rx = Receiver(_l2c_config(reacq_interval_blocks=blocks), device=dev)
        rx.preload(x)
        with _counting(cc, tc) as c:
            t0 = time.perf_counter()
            rx.process(x)
            wall = time.perf_counter() - t0
        _check_launches(cc, tc, c["chunks"], f"L2C alone, {blocks} blocks")
        out[blocks] = {"segments": c["calls"], "rtf": DUAL_S / wall}
    return out


def _write_capture(x, path, item_type, scale):
    """Interleaved I/Q integers (int16 for ishort, int8 for ibyte)."""
    dt = np.int16 if item_type == "ishort" else np.int8
    lim = np.iinfo(dt).max
    step = 1 << 22
    with open(path, "wb") as f:
        for a in range(0, len(x), step):
            y = x[a:a + step]
            iq = np.empty(2 * len(y), dtype=dt)
            iq[0::2] = np.clip(np.round(y.real * scale), -lim, lim)
            iq[1::2] = np.clip(np.round(y.imag * scale), -lim, lim)
            iq.tofile(f)


def _glonass_duplicates(rxs, used, what):
    """The GLONASS satellites behind glonass_l1_gps_l1_ibyte.conf's joint
    fixes.  The conf maps no FDMA slot, so every 1G channel runs at k = 0,
    and on a capture with one slot at k = 0 every channel that locks
    tracks that one satellite under its own PRN key: the R count of the
    last fix is that satellite counted once per channel.  Distinct
    satellites are counted by their decoded state vectors (strings 1-3),
    the slot from string 4 where it was decoded; raises unless the count
    is one satellite, the capture's slot, behind every R measurement."""
    (glo,) = [r for r in rxs if r.cfg.signal_id == "1G"]
    done = [d for d in glo.decoders.values() if d.ephemeris_complete]
    sats = {(e.tb_s, e.x_km, e.y_km, e.z_km)
            for e in (d.ephemeris for d in done)}
    slots = sorted({d.ephemeris.slot for d in done if 4 in d.raw.strings})
    n_r = int(re.search(r"R:(\d+)", used).group(1))
    if len(sats) != 1 or slots not in ([], [GLO_CONF_SLOT]) \
            or n_r > len(done):
        raise AssertionError(
            f"{what}: {len(sats)} GLONASS state vectors, decoded slots "
            f"{slots}, R:{n_r} in the last fix over {len(done)} complete "
            f"ephemerides; the capture holds slot {GLO_CONF_SLOT} alone")
    return {"in_last_fix": n_r, "satellites": len(sats),
            "slots": slots or "not decoded", "channels": len(done)}


def phase_cli_multi(dev, cc, tc, x_mix):
    """Phase 18: the CLI on the four confs this slice ports, each over a
    capture written in its item type and deleted after its runs:
    hybrid_ishort.conf and multisource_hybrid_ishort.conf on phase 16's
    capture (ishort, --signal_file), glonass_l1_gps_l1_ibyte.conf on GPS +
    a GLONASS slot at k = 0 at 6.625 Msps (ibyte), all as written; and
    gps_l2c_ibyte.conf on a 3 Msps L2CM capture (ibyte) as written (its
    second acquisition step, 40 Hz apart, leaves up to 20 Hz of Doppler
    error, and the 20 ms Costas loop locks +-25 Hz off on such channels:
    no fix bar) and with Acquisition_2S.doppler_step=20 (the first step
    then within 10 Hz)."""
    CACHE.mkdir(exist_ok=True)
    reps = {}
    scen_mix = _cells()["mixed 1B"][0]
    # the hybrid confs search 32 PRNs per group on 6 + 4 channels, at
    # phase 16's bars
    runs = [("hybrid_ishort.conf", None, "ishort", ISHORT_SCALE, scen_mix,
             "1C+1B (6/4 channels)", MIN_FIXES_MIX, MAX_MEDIAN_MIX),
            ("multisource_hybrid_ishort.conf", None, "ishort", ISHORT_SCALE,
             scen_mix, "1C+1B (6/4 channels)", MIN_FIXES_MIX,
             MAX_MEDIAN_MIX),
            ("glonass_l1_gps_l1_ibyte.conf", None, "ibyte", IBYTE_SCALE,
             _cells()["conf 1G"][0], "1C+1G (6/4 channels)", MIN_FIXES_GLO,
             MAX_MEDIAN_GLO),
            ("gps_l2c_ibyte.conf", None, "ibyte", IBYTE_SCALE,
             _cells()["conf 2S"][0], None, 0, None),
            ("gps_l2c_ibyte.conf", ("Acquisition_2S.doppler_step=", 20),
             "ibyte", IBYTE_SCALE, _cells()["conf 2S"][0], None, 10, None)]
    path = None
    for name, edit, item_type, scale, scen, mixed, min_fixes, max_med \
            in runs:
        t0 = time.perf_counter()
        gen_s = 0.0
        if path is None or not path.name.startswith(f"cli_{name[:-5]}."):
            if path is not None:
                path.unlink(missing_ok=True)
            if name.startswith("glonass"):
                x, gen_s = card_capture(dev, ["conf 1C", "conf 1G"], 104,
                                        cn0_all=True)
            elif name.startswith("gps_l2c"):
                x, gen_s = card_capture(dev, ["conf 2S"], 105)
            else:
                x = x_mix
            path = CACHE / f"cli_{name[:-5]}.{item_type}"
            _write_capture(x, path, item_type, scale)
            del x
        write_s = time.perf_counter() - t0
        conf = ROOT / "conf" / name
        if edit is not None:
            key, value = edit
            text, n = re.subn(f"^{re.escape(key)}.*$", f"{key}{value}",
                              conf.read_text(), flags=re.M)
            if n != 1:
                raise AssertionError(f"{name} has no {key}")
            conf = CACHE / f"{name[:-5]}_edited.conf"
            conf.write_text(text)
            name = f"{name}, {key}{value}"
        what = f"CLI {name}"
        rxs = []
        try:
            with _counting(cc, tc) as counter:
                rep = _run_cli(["-c", str(conf), "--signal_file", str(path)],
                               scen, CACHE / f"cli_{name[:12]}", min_fixes,
                               what, max_median_m=max_med,
                               joint=mixed is not None, receivers=rxs)
        except BaseException:
            path.unlink(missing_ok=True)
            raise
        rep = _cli_launches(cc, tc, rep, counter, what)
        if mixed is not None:
            line = f"Mixed-constellation run: {mixed}"
            if line not in rep["lines"]:
                raise AssertionError(f"{what}: no '{line}' line")
            final = [ln for ln in rep["lines"]
                     if ln.startswith("Final joint fix:")]
            used = final[0] if final else ""
            want = "R:" if "1G" in mixed else "E:"
            if want not in used:
                raise AssertionError(f"{what}: the last joint fix does not "
                                     f"use {want[0]}: {used!r}")
            if "1G" in mixed:
                rep["glonass"] = _glonass_duplicates(rxs, used, what)
                rep["summary"] += (
                    f", the last fix's R:{rep['glonass']['in_last_fix']} "
                    f"is {rep['glonass']['satellites']} GLONASS satellite "
                    f"(slot {rep['glonass']['slots']}) on "
                    f"{rep['glonass']['channels']} channels at k = 0")
        rep.update(capture_s=gen_s, write_s=write_s)
        reps[name] = rep
        log(f"[18] CLI, {name}: {rep['summary']}"
            + (" (no median bar)" if max_med is None else "")
            + f" | capture {gen_s:.2f} s + file {write_s - gen_s:.1f} s")
    path.unlink(missing_ok=True)
    return reps


# ---------------------------------------------------------------------------
# phases 31-33: A-GNSS, PPP and RTK
# ---------------------------------------------------------------------------


def _write_ishort(x, path):
    """A capture as interleaved int16 I/Q at ISHORT_SCALE, in slices."""
    step = 1 << 22
    with open(path, "wb") as f:
        for a in range(0, len(x), step):
            y = x[a:a + step]
            iq = np.empty(2 * len(y), dtype=np.int16)
            iq[0::2] = np.clip(np.round(y.real * ISHORT_SCALE), -32767, 32767)
            iq[1::2] = np.clip(np.round(y.imag * ISHORT_SCALE), -32767, 32767)
            iq.tofile(f)
    return path


def _offset_from(ecef, east_m, north_m):
    """`ecef` moved east_m east and north_m north on the local tangent
    plane."""
    from gnss_sdr_1_tpu_torch.pvt.geodesy import ecef_to_llh

    lat, lon, _ = ecef_to_llh(ecef)
    east = np.array([-np.sin(lon), np.cos(lon), 0.0])
    north = np.array([-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon),
                      np.cos(lat)])
    return np.asarray(ecef, np.float64) + east_m * east + north_m * north


def _first_fix_s(rx, scen):
    return (rx.solutions[0].rx_time_tow_s - scen.t0_tow
            if rx.solutions else float("nan"))


def _agnss_cli(cc, tc, scen, argv, out, what, assisted):
    """One run of conf/gps_l1_supl_assisted.conf through the CLI on the
    card, counted; its Receiver, and the visible count it printed."""
    rxs = []
    with _counting(cc, tc) as counter:
        rep = _run_cli(argv, scen, out, MIN_FIXES_AGNSS, what,
                       receivers=rxs)
    rep = _cli_launches(cc, tc, rep, counter, what)
    (rx,) = rxs
    vis = [ln for ln in rep["lines"] if "satellites predicted visible" in ln]
    if assisted and (len(vis) != 1 or rx._assist_acq is None):
        raise AssertionError(f"{what}: no assisted program ({vis})")
    rep.update(rx=rx, first_fix_s=_first_fix_s(rx, scen),
               visible=(int(vis[0].split(": ")[1].split()[0]) if vis
                        else None),
               acq={p: list(v) for p, v in rx._acq_info.items()})
    return rep


def _acq_ms(acq, head, n=AGNSS_ACQ_CALLS):
    """ms a call of acq.acquire on the head of the capture: from CUDA events
    around n calls (each call's uploads and readback included), and the
    sum of its kernels' device time from a profiler trace of n calls."""
    def call():
        return acq.acquire(head)

    return _time_cuda(call, n), _device_ms(call, n)


def phase_agnss(dev, cc, tc):
    """Phase 31: conf/gps_l1_supl_assisted.conf over phase 5's scenario made
    at the conf's 2.046 Msps: with --supl from a SuplServer on 127.0.0.1, cold,
    and with --assist; then a hot start from the cold run's brdc.rnx."""
    from gnss_sdr_1_tpu_torch.pvt.geodesy import ecef_to_llh
    from gnss_sdr_1_tpu_torch.pvt.rinex_reader import read_rinex_nav
    from gnss_sdr_1_tpu_torch.runtime import Receiver
    from gnss_sdr_1_tpu_torch.runtime.assistance import save_assistance
    from gnss_sdr_1_tpu_torch.runtime.config import (FileConfiguration,
                                                     to_receiver_config)
    from gnss_sdr_1_tpu_torch.runtime.supl import SuplAssist, SuplServer

    scen = _cells()["agnss"][0]
    x, gen_s = card_capture(dev, ["agnss"], 1234)
    t0 = time.perf_counter()
    path = _write_ishort(x, CACHE / f"agnss_{FS_AGNSS:.0f}.ishort")
    write_s = time.perf_counter() - t0
    conf = ROOT / "conf" / "gps_l1_supl_assisted.conf"
    lat, lon, h = ecef_to_llh(_offset_from(scen.rx_ecef, AGNSS_REF_OFFSET_M,
                                           0.0))
    ref_llh = (float(np.degrees(lat)), float(np.degrees(lon)), float(h))
    week = next(iter(scen.ephemerides.values())).week
    argv = ["-c", str(conf), "--signal_file", str(path), "--channels",
            str(AGNSS_CHANNELS)]
    srv = SuplServer(SuplAssist(
        ref_time_week=week, ref_time_tow_s=scen.t0_tow,
        ref_lat_deg=ref_llh[0], ref_lon_deg=ref_llh[1], ref_alt_m=ref_llh[2],
        has_ref_location=True, ephemerides=dict(scen.ephemerides)),
        host="127.0.0.1", port=0)
    try:
        supl = _agnss_cli(cc, tc, scen, argv + [
            "--supl", f"127.0.0.1:{srv.port}"], CACHE / "agnss_supl",
            "A-GNSS SUPL", True)
    finally:
        srv.close()
    cold = _agnss_cli(cc, tc, scen, argv, CACHE / "agnss_cold", "A-GNSS cold",
                      False)
    jpath = CACHE / "agnss.json"
    save_assistance(str(jpath), scen.ephemerides, ref_llh=ref_llh,
                    ref_tow_s=scen.t0_tow)
    assist = _agnss_cli(cc, tc, scen, argv + ["--assist", str(jpath)],
                        CACHE / "agnss_assist", "A-GNSS --assist", True)
    step = supl["rx"].cfg.doppler_step_hz
    for name, run in (("SUPL", supl), ("--assist", assist)):
        if set(run["acq"]) != set(cold["acq"]):
            raise AssertionError(f"A-GNSS {name}: assigned "
                                 f"{sorted(run['acq'])}, cold "
                                 f"{sorted(cold['acq'])}")
        off = {p: abs(run["acq"][p][1] - cold["acq"][p][1])
               for p in cold["acq"]}
        if max(off.values()) > step:
            raise AssertionError(f"A-GNSS {name}: acquisition Doppler off "
                                 f"the cold run's by {off} Hz")
        run["max_doppler_off_hz"] = max(off.values())
        if run["fixes"] < (1.0 - AGNSS_FIX_SHARE) * cold["fixes"]:
            raise AssertionError(f"A-GNSS {name}: {run['fixes']} fixes, cold "
                                 f"{cold['fixes']}")
    # both programs on the same samples, timed on the card
    rx = supl["rx"]
    head = x[:rx.acq.cfg.fft_size * max(1, rx.cfg.acq_dwells)]
    grids = {"cold": (rx.acq, _acq_ms(rx.acq, head)),
             "assisted": (rx._assist_acq, _acq_ms(rx._assist_acq, head))}
    # the hot start: the cold run's broadcast ephemerides from its RINEX nav
    ephs = read_rinex_nav(str(CACHE / "agnss_cold" / "brdc.rnx"))
    rcfg = to_receiver_config(FileConfiguration(str(conf)))
    hot = Receiver(type(rcfg)(**{**rcfg.__dict__,
                                 "n_channels": AGNSS_CHANNELS}), device=dev)
    hot.load_ephemerides(ephs)
    hot.preload(x)
    with _counting(cc, tc) as counter:
        t0 = time.perf_counter()
        sols = hot.process(x)
        wall = time.perf_counter() - t0
    _check_launches(cc, tc, counter["chunks"], "A-GNSS hot start")
    hot_rep = {**_errors_3d([s.rx_ecef_m for s in sols], scen,
                            "A-GNSS hot start", MIN_FIXES_AGNSS),
               "first_fix_s": _first_fix_s(hot, scen), "rtf": E2E_S / wall,
               "wall_s": wall, "ephemerides": len(ephs),
               "launches_chunk_corr": cc.launches,
               "launches_track_chain": tc.launches,
               "chunks": counter["chunks"]}
    if not hot_rep["first_fix_s"] < cold["first_fix_s"]:
        raise AssertionError(f"A-GNSS hot start: first fix at "
                             f"{hot_rep['first_fix_s']:.2f} s, cold "
                             f"{cold['first_fix_s']:.2f} s")
    for run in (supl, cold, assist):
        del run["rx"]
    del x
    return {"supl": supl, "cold": cold, "assist": assist, "hot": hot_rep,
            "grids": {k: {"bins": a.cfg.num_doppler_bins,
                          "prns": len(a.prns), "fft_size": a.cfg.fft_size,
                          "ms_per_call": ms, "device_ms_per_call": dev_ms}
                      for k, (a, (ms, dev_ms)) in grids.items()},
            "gen_s": gen_s, "write_s": write_s}


def _ishort_conf(name, capture, **extra):
    """conf/gps_l1_ishort.conf over phase 6's capture: its Direct_Resampler
    set to the capture's 4.092 Msps in and 2.046 Msps out, 12 channels, the
    rest as written; `extra` adds or overrides keys (dots written as
    '__')."""
    items = {}
    for ln in (ROOT / "conf" / "gps_l1_ishort.conf").read_text().splitlines():
        ln = ln.split(";")[0].strip()
        if "=" in ln and not ln.startswith("["):
            k, v = ln.split("=", 1)
            items[k.strip()] = v.strip()
    items.update({
        "SignalSource.filename": str(capture),
        "SignalSource.sampling_frequency": f"{FS:.0f}",
        "Resampler.sample_freq_in": f"{FS:.0f}",
        "Resampler.sample_freq_out": f"{FS / 2:.0f}",
        "GNSS-SDR.internal_fs_sps": f"{FS / 2:.0f}",
        "Channels_1C.count": "12"})
    items.update({k.replace("__", "."): str(v) for k, v in extra.items()})
    path = CACHE / name
    path.write_text("".join(f"{k}={v}\n" for k, v in items.items()))
    return path


@contextlib.contextmanager
def _recorded(owner, name, calls):
    """Wrap owner.name so that each call appends (result, wall seconds) to
    `calls`."""
    fn = getattr(owner, name)

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        calls.append((out, time.perf_counter() - t))
        return out

    setattr(owner, name, wrapped)
    try:
        yield calls
    finally:
        setattr(owner, name, fn)


def phase_ppp(cc, tc, scen, capture):
    """Phase 32: conf/gps_l1_ishort.conf with PVT.positioning_mode=
    PPP_Static on the first PPP_RTK_S of phase 6's file, with broadcast
    orbits and with an SP3 made from the scenario's ephemerides
    (sp3_from_broadcast, write_sp3)."""
    from gnss_sdr_1_tpu_torch.pvt.precise import sp3_from_broadcast, write_sp3
    from gnss_sdr_1_tpu_torch.runtime.receiver import Receiver

    sp3 = CACHE / "ppp.sp3"
    write_sp3(sp3, sp3_from_broadcast(
        scen.ephemerides, scen.t0_tow - 900.0, scen.t0_tow + E2E_S + 900.0,
        step_s=300.0, week=next(iter(scen.ephemerides.values())).week))
    reps = {}
    for name, extra in (("broadcast", {}), ("sp3", {"PVT__sp3_file": sp3})):
        what = f"PPP {name}"
        conf = _ishort_conf(f"ppp_{name}.conf", capture,
                            PVT__positioning_mode="PPP_Static", **extra)
        with _counting(cc, tc) as counter, \
                _recorded(Receiver, "solve_ppp_batch", []) as calls:
            rep = _run_cli(["-c", str(conf), "--max_s", f"{PPP_RTK_S:g}"],
                           scen, CACHE / f"ppp_{name}", MIN_FIXES_PPP_RTK,
                           what)
        rep = _cli_launches(cc, tc, rep, counter, what)
        (sol, wall), = calls
        line = [ln for ln in rep["lines"] if ln.startswith("PPP (")]
        if not sol.valid or len(line) != 1:
            raise AssertionError(f"{what}: no valid PPP solution ({line})")
        rep.update(ppp_wall_s=wall, epochs=sol.n_epochs, arcs=sol.n_arcs,
                   sigma0_m=sol.sigma0_m, ztd_wet_m=sol.ztd_wet_m,
                   err_3d_m=float(np.linalg.norm(sol.rx_ecef_m
                                                 - scen.rx_ecef)),
                   ppp_line=line[0])
        reps[name] = rep
    return reps


def phase_rtk(dev, cc, tc, scen, capture):
    """Phase 33: a base 500 m from the rover over the same satellites (30 s
    at 4.092 Msps, made on the card) through the CLI, which writes its
    observables.rtcm; then the rover's CLI on the first PPP_RTK_S of phase
    6's file with --base_obs on it, PVT.positioning_mode=DGNSS (the batch
    solver) and Kinematic (the EKF)."""
    from gnss_sdr_1_tpu_torch.pvt import rtk, rtk_ekf
    from gnss_sdr_1_tpu_torch.pvt.rtcm import read_base_observables

    base_scen = _cells()["base"][0]
    if base_scen.ephemerides != scen.ephemerides:
        raise AssertionError("RTK: the base's ephemerides are not the "
                             "rover's")
    truth_m = float(np.linalg.norm(base_scen.rx_ecef - scen.rx_ecef))
    xb, gen_s = card_capture(dev, ["base"], RTK_BASE_SEED)
    base_path = _write_ishort(xb, CACHE / "rtk_base.ishort")
    del xb
    what = "RTK base"
    with _counting(cc, tc) as counter:
        base = _run_cli(["--signal_file", str(base_path), "--item_type",
                         "ishort", "--fs", f"{FS:.0f}", "--channels", "12"],
                        base_scen, CACHE / "rtk_base", MIN_FIXES, what)
    base = _cli_launches(cc, tc, base, counter, what)
    base_path.unlink(missing_ok=True)
    rtcm = CACHE / "rtk_base" / "observables.rtcm"
    base_ecef, base_epochs = read_base_observables(rtcm.read_bytes())
    reps = {"base": base}
    for mode, owner, fn in (("DGNSS", rtk, "solve_baseline"),
                            ("Kinematic", rtk_ekf, "solve_baseline_ekf")):
        what = f"RTK {mode}"
        conf = _write_conf(f"rtk_{mode}.conf", capture,
                           "GPS_L1_CA_DLL_PLL_Tracking",
                           PVT__positioning_mode=mode)
        with _counting(cc, tc) as counter, \
                _recorded(owner, fn, []) as calls:
            rep = _run_cli(["-c", str(conf), "--base_obs", str(rtcm),
                            "--max_s", f"{PPP_RTK_S:g}"], scen,
                           CACHE / f"rtk_{mode}", MIN_FIXES_PPP_RTK, what)
        rep = _cli_launches(cc, tc, rep, counter, what)
        (sol, wall), = calls
        if mode == "DGNSS":
            valid, fixed, ratio = sol.valid, sol.fixed, sol.ratio
            pos = sol.rover_ecef_m
            n_ep = sol.n_epochs
        else:
            valid = bool(sol)
            last = sol[-1] if sol else None
            fixed = bool(last and last.fixed)
            ratio = last.ratio if last else float("nan")
            pos = (last.rover_fixed_ecef_m if fixed
                   else last.rover_float_ecef_m) if last else None
            n_ep = len(sol)
        line = [ln for ln in rep["lines"] if ln.startswith("RTK ")]
        if not valid or len(line) != 1:
            raise AssertionError(f"{what}: no valid baseline ({line})")
        length = float(np.linalg.norm(pos - base_ecef))
        rep.update(valid=valid, fixed=fixed, ratio=float(ratio),
                   epochs=n_ep, rtk_wall_s=wall, baseline_m=length,
                   baseline_err_m=length - truth_m,
                   rover_err_3d_m=float(np.linalg.norm(pos - scen.rx_ecef)),
                   rtk_line=line[0])
        reps[mode] = rep
    reps.update(truth_m=truth_m, base_epochs=len(base_epochs),
                base_ecef_err_m=float(np.linalg.norm(
                    base_ecef - base_scen.rx_ecef)), gen_s=gen_s)
    return reps


# ---------------------------------------------------------------------------
# phase 34: the channel-sharded receiver over a mesh
# ---------------------------------------------------------------------------

# logical shards of cuda:0 when the machine holds one card; the gather run's
# span of phase 5's capture; the conditioner's span of phase 7's file; the
# profiled segment; the weak-scaling spans and channels a shard
SHARD_COUNTS = (2, 4)
SHARD_GATHER_S = 10.0
SHARD_COND_S = 2.0
SHARD_PROFILE_S = 1.0
SHARD_SCALING_S = 3.0
SHARD_CHANNELS = 12


def _shard_meshes():
    """(what the [34] line says, the device lists of the meshes): every
    visible device when there are two or more (as many as split 12
    channels), else 2 and 4 logical shards of cuda:0."""
    n = torch.cuda.device_count()
    if n >= 2:
        k = max(d for d in range(2, n + 1) if SHARD_CHANNELS % d == 0)
        return (f"{k} of {n} devices, one shard each",
                [[f"cuda:{i}" for i in range(k)]])
    return ("one device: 2 and 4 logical shards of cuda:0, each on its own "
            "stream", [["cuda:0"] * k for k in SHARD_COUNTS])


@contextlib.contextmanager
def _engine_launches(cc, tc, gb):
    """The kernel launches of every TrackingEngine capture call inside the
    block by engine (the counters' change across the call), beside the
    chunks (chunked) or segments (gather) each call runs, counted apart
    from the counters; the counters are set to 0 first; the symbol-grid
    kernel by _symbol_counting."""
    from gnss_sdr_1_tpu_torch.track.engine import TrackingEngine

    rec = {}
    run = TrackingEngine._run_capture

    def counted(self, samples, state, limit, n_epochs):
        before = (cc.launches, tc.launches, gb.launches)
        out = run(self, samples, state, limit, n_epochs)
        r = rec.setdefault(id(self), {"units": 0, "chunk_corr": 0,
                                      "track_chain": 0, "gather_block": 0})
        r["units"] += (1 if self.correlator == "gather"
                       else -(-n_epochs // self.chain_spec.E))
        for k, b, a in zip(("chunk_corr", "track_chain", "gather_block"),
                           before, (cc.launches, tc.launches, gb.launches)):
            r[k] += a - b
        return out

    TrackingEngine._run_capture = counted
    cc.launches = tc.launches = gb.launches = 0
    try:
        with _symbol_counting():
            yield rec
    finally:
        TrackingEngine._run_capture = run


def _shard_launches(sen, rec, what):
    """Each shard's launches against its chunks or segments: (launches a
    shard, units a shard, the run's launches by kernel)."""
    gather = sen.correlator == "gather"
    kernels = ("gather_block",) if gather else ("chunk_corr", "track_chain")
    per, units = [], []
    for j, e in enumerate(sen.engines):
        r = rec.get(id(e))
        if r is None or not r["units"] > 0:
            raise AssertionError(f"{what}: shard {j} ran no capture call")
        for k in kernels:
            if r[k] != r["units"]:
                raise AssertionError(f"{what}: shard {j} launched {k} "
                                     f"{r[k]} times for {r['units']} "
                                     f"{'segments' if gather else 'chunks'}")
        other = {"chunk_corr", "track_chain", "gather_block"} - set(kernels)
        if any(r[k] for k in other):
            raise AssertionError(f"{what}: shard {j} launched {r}")
        per.append(r[kernels[0]])
        units.append(r["units"])
    total = {f"launches_{k}": sum(rec[id(e)][k] for e in sen.engines)
             for k in ("chunk_corr", "track_chain", "gather_block")}
    return per, units, total


def _same_rows(got, want, what):
    """Every field of two TrackOutputs / SymbolOutputs equal, row for
    row."""
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{what}: {name} differs from the unsharded "
                                 f"run")


def _same_state(sharded, want, what):
    from gnss_sdr_1_tpu_torch.parallel import gather_channel_tree
    from gnss_sdr_1_tpu_torch.track.engine import state_to_numpy

    a = state_to_numpy(gather_channel_tree(sharded))
    for k, v in state_to_numpy(want).items():
        for x, y in zip(a[k] if isinstance(v, tuple) else (a[k],),
                        v if isinstance(v, tuple) else (v,)):
            if not np.array_equal(x, y):
                raise AssertionError(f"{what}: final state {k} differs from "
                                     f"the unsharded run")


def _sharded_run(cc, tc, gb, eng, st, x, devices, span, what, symbols=False):
    """The unsharded engine and its sharded twin over `devices` on the
    same samples and state: every row and the final state equal, each
    shard's launches == its chunks / segments; the sharded run's record."""
    from gnss_sdr_1_tpu_torch.parallel import (ChannelShardedEngine,
                                               channel_mesh, replicate,
                                               shard_channel_tree)

    mesh = channel_mesh(devices=devices)
    sen = ChannelShardedEngine(eng.cfg, eng._codes_np, mesh=mesh)
    xd = torch.as_tensor(x, device=eng.device)
    xs = replicate(xd, mesh)
    sst = shard_channel_tree(st, mesh)
    sym_off = np.full(eng.cfg.n_channels, 20, dtype=np.int32)

    def call(e, samples, state):
        if symbols:
            return e.track_capture_symbols(samples, state, span, sym_off, 20)
        return e.track_capture(samples, state, span)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st1, o1 = call(eng, xd, st)
    t1 = time.perf_counter() - t0
    with _engine_launches(cc, tc, gb) as rec:
        t0 = time.perf_counter()
        st2, o2 = call(sen, xs, sst)
        t2 = time.perf_counter() - t0
    _same_rows(o2, o1, what)
    _same_state(st2, st1, what)
    per, units, total = _shard_launches(sen, rec, what)
    valid = int((o1.n_valid if symbols else o1.valid).sum())
    return {"what": what, "shards": len(devices), "valid": valid,
            "launches_per_shard": per, "units_per_shard": units,
            "unit": "segments" if sen.correlator == "gather" else "chunks",
            "wall_s": t2, "unsharded_wall_s": t1, **total}


def _shard_acquisition(dev, x, meshes):
    from gnss_sdr_1_tpu_torch.acquire import AcqConfig, PcpsAcquisition
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.parallel import (ChannelShardedAcquisition,
                                               channel_mesh)

    cfg = AcqConfig(fs_hz=FS, samples_per_code=4092, samples_per_chip=4,
                    doppler_max_hz=5000.0, doppler_step_hz=250.0,
                    max_dwells=2, make_two_steps=False)
    codes = {p: gps_l1ca_code(p) for p in range(1, 33)}
    head = x[: cfg.fft_size * cfg.max_dwells]
    one = PcpsAcquisition(cfg, codes, fs_code_rate=(1.023e6, 1023),
                          device=dev)
    want = one.acquire(head)
    ms = {}
    for devices in meshes:
        sh = ChannelShardedAcquisition(
            cfg, codes, mesh=channel_mesh(devices=devices),
            fs_code_rate=(1.023e6, 1023))
        got = sh.acquire(head)
        for name in ("positive", "delay_samples", "doppler_hz", "test_stat"):
            if not np.array_equal(getattr(got, name), getattr(want, name)):
                raise AssertionError(f"sharded acquisition over {devices}: "
                                     f"{name} differs from the unsharded "
                                     f"grid")
        ms[len(devices)] = _wall_ms(lambda: sh.acquire(head))
    return {"prns": 32, "bins": cfg.num_doppler_bins,
            "fft_size": cfg.fft_size, "dwells": cfg.max_dwells, "ms": ms,
            "unsharded_ms": _wall_ms(lambda: one.acquire(head)),
            "positive": int(want.positive.sum())}


def _wall_ms(fn, n=5):
    """Host wall per call over n calls after one (each call ends in its
    readback)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def _shard_conditioner(dev, if_file, meshes):
    from gnss_sdr_1_tpu_torch.condition import (Conditioner,
                                                design_lowpass_fir)
    from gnss_sdr_1_tpu_torch.io import FileSignalSource
    from gnss_sdr_1_tpu_torch.parallel import (freq_xlating_fir_time_sharded,
                                               time_mesh)

    head = FileSignalSource(str(if_file), item_type="ishort",
                            sampling_frequency=FS).read(
                                0, int(FS * SHARD_COND_S))
    # phase 7's FrontEnd: 65 taps, decimation 2 to FS_IF
    taps = design_lowpass_fir(65, 0.45 * min(FS / 2, FS_IF), FS)
    args = (taps, FS, IF_HZ, 2)

    def one():
        return Conditioner(*args, device=dev).process(head, flush=True)

    want = one()
    ms = {}
    for devices in meshes:
        mesh = time_mesh(devices=devices)
        got = freq_xlating_fir_time_sharded(head, *args, mesh=mesh)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"time-sharded conditioner over {devices} "
                                 f"differs from one device's")
        ms[len(devices)] = _wall_ms(
            lambda: freq_xlating_fir_time_sharded(head, *args, mesh=mesh))
    return {"taps": len(taps), "seconds": SHARD_COND_S, "ms": ms,
            "one_ms": _wall_ms(one), "halo": len(taps) - 1,
            "samples_out": int(want.shape[0])}


def _shard_profile(dev, sats, x, devices):
    """A profiler trace of one sharded 1 s segment (launch to harvest) of
    the chunked engine: its kernels, peer copies and NCCL kernels."""
    from gnss_sdr_1_tpu_torch.parallel import (ChannelShardedEngine,
                                               channel_mesh, replicate)

    eng = _engine(dev)
    mesh = channel_mesh(devices=devices)
    sen = ChannelShardedEngine(eng.cfg, eng._codes_np, mesh=mesh)
    st = _activate_all(sen, sats)
    span = int(FS * SHARD_PROFILE_S)
    xs = replicate(x[: span + eng.cfg.epoch_samples_max], mesh)
    for _ in range(3):
        events = _trace(lambda: sen.track_capture(xs, st, span), 1)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if kernels:
            break
    else:
        raise NoKernelEvent("3 profiler traces of a sharded segment hold no "
                            "kernel event")
    peer = [e for e in events if "ptop" in e.get("name", "").lower()]
    nccl = [e for e in kernels if "nccl" in e["name"].lower()]
    if peer or nccl:
        raise AssertionError(f"a sharded segment moved data between devices: "
                             f"{len(peer)} peer copies, {len(nccl)} NCCL "
                             f"kernels")
    memcpy = {}
    for e in events:
        if e.get("cat") == "gpu_memcpy":
            memcpy[e["name"]] = memcpy.get(e["name"], 0) + 1
    return {"seconds": SHARD_PROFILE_S, "shards": len(devices),
            "kernels": len(kernels), "peer_copies": len(peer),
            "nccl": len(nccl), "memcpy": memcpy}


def _shard_scaling(dev, sats, x):
    """Channel-samples a second of the chunked engine's track_capture at 1,
    2 and 4 shards of SHARD_CHANNELS channels each (real devices where the
    machine holds as many, else logical shards of cuda:0), the best of
    three timed calls after one, and the efficiency against one shard."""
    from gnss_sdr_1_tpu_torch.parallel import (ChannelShardedEngine,
                                               channel_mesh, replicate)

    base = _engine(dev)
    span = int(FS * SHARD_SCALING_S)
    real = torch.cuda.device_count()
    rates = {}
    for n in (1, 2, 4):
        devices = ([f"cuda:{i}" for i in range(n)] if real >= n
                   else ["cuda:0"] * n)
        mesh = channel_mesh(devices=devices)
        C = SHARD_CHANNELS * n
        sen = ChannelShardedEngine(
            dataclasses.replace(base.cfg, n_channels=C),
            base._codes_np, mesh=mesh)
        st = sen.init_state()
        rate = base.cfg.chip_rate_chips_s * base.cfg.code_samples_per_chip
        for ch in range(C):
            s = sats[ch % len(sats)]
            st = sen.activate_channel(st, ch, ch % len(sats),
                                      s.delay_chips / rate * FS,
                                      s.doppler_hz, 0, 0)
        xs = replicate(x[: span + base.cfg.epoch_samples_max], mesh)
        sen.track_capture(xs, st, span)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, out = sen.track_capture(xs, st, span)
            walls.append(time.perf_counter() - t0)
        if not out.valid.sum() > 0.85 * C * SHARD_SCALING_S * 1e3:
            raise AssertionError(f"scaling run at {n} shards: "
                                 f"{int(out.valid.sum())} valid epochs")
        rates[n] = {"wall_s": min(walls), "rate": C * span / min(walls)}
    for n, r in rates.items():
        r["efficiency"] = r["rate"] / n / rates[1]["rate"]
    return {"span_s": SHARD_SCALING_S,
            "kind": ("real devices" if real >= 4 else
                     "logical shards of cuda:0 beyond the machine's "
                     f"{real} device(s)"), "rates": rates}


def phase_sharded(dev, cc, tc, gb, x_eng, scen, x_e2e, if_file):
    """Phase 34: the channel-sharded engine, acquisition and conditioner
    over the meshes of _shard_meshes, each held to the unsharded run on
    the same card; a profile of a sharded segment; weak scaling.  `x_eng`
    is phase 4's capture (its satellites are the engine cell's), `scen`
    and `x_e2e` phase 5's, `if_file` phase 7's."""
    what, meshes = _shard_meshes()
    sats = _cells()["engine"][2]
    runs = []
    eng = _engine(dev)
    st = _activate_all(eng, sats)
    span = len(x_eng) - eng.cfg.epoch_samples_max
    geng = _engine(dev, correlator="gather")
    gst = _activate_all(geng, scen.sats)
    gspan = int(FS * SHARD_GATHER_S)
    gx = x_e2e[: gspan + geng.cfg.epoch_samples_max]
    for devices in meshes:
        runs.append(_sharded_run(
            cc, tc, gb, eng, st, x_eng, devices, span,
            f"engine (phase 4), chunked, track_capture, {ENGINE_S:g} s"))
        runs.append(_sharded_run(
            cc, tc, gb, eng, st, x_eng, devices, span,
            f"engine (phase 4), chunked, track_capture_symbols, "
            f"{ENGINE_S:g} s", symbols=True))
        runs.append(_sharded_run(
            cc, tc, gb, geng, gst, gx, devices, gspan,
            f"phase 5's capture, gather, track_capture, "
            f"{SHARD_GATHER_S:g} s"))
    return {
        "mesh": what, "runs": runs,
        "chunked_runs": [r for r in runs if r["unit"] == "chunks"],
        "gather_runs": [r for r in runs if r["unit"] == "segments"],
        "acquisition": _shard_acquisition(dev, x_eng, meshes),
        "conditioner": _shard_conditioner(dev, if_file, meshes),
        "profile": _shard_profile(dev, sats, x_eng, meshes[-1]),
        "scaling": _shard_scaling(dev, sats, x_eng)}


if __name__ == "__main__":
    main()
