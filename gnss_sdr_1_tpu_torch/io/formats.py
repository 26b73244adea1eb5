"""Raw IQ sample formats and conversion to complex64.

Reference parity: the item_type config values accepted by File_Signal_Source
plus the data-type adapters (src/algorithms/data_type_adapter/adapters/):
  byte          real int8
  short         real int16
  ibyte         interleaved I/Q int8    (Ibyte_To_Complex)
  ishort        interleaved I/Q int16   (Ishort_To_Complex)
  cbyte         complex int8 pairs      (same memory layout as ibyte)
  cshort        complex int16 pairs     (same memory layout as ishort)
  gr_complex    complex64
Real formats are converted to analytic baseband by the conditioner's
freq-xlating stage; here they become complex with zero Q.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SampleFormat:
    name: str
    dtype: np.dtype
    items_per_sample: int        # raw dtype items consumed per complex sample
    samples_per_item: int = 1    # sub-byte packings: complex samples per item

    @property
    def bytes_per_sample(self) -> float:
        return (self.dtype.itemsize * self.items_per_sample
                / self.samples_per_item)


FORMATS: dict[str, SampleFormat] = {
    "byte": SampleFormat("byte", np.dtype(np.int8), 1),
    "short": SampleFormat("short", np.dtype(np.int16), 1),
    "ibyte": SampleFormat("ibyte", np.dtype(np.int8), 2),
    "ishort": SampleFormat("ishort", np.dtype(np.int16), 2),
    "cbyte": SampleFormat("cbyte", np.dtype(np.int8), 2),
    "cshort": SampleFormat("cshort", np.dtype(np.int16), 2),
    "gr_complex": SampleFormat("gr_complex", np.dtype(np.complex64), 1),
    # packed front-end formats (unpack_byte_2bit_cpx_samples.cc:75-95 /
    # unpack_byte_4bit_samples): 2-bit signed I/Q nibble-packed 2 complex
    # samples per byte [MS nibble first, nibble = Q1 Q0 I1 I0]; 4-bit
    # signed I/Q one complex sample per byte [Q nibble high, I low]
    "2bits_cpx": SampleFormat("2bits_cpx", np.dtype(np.uint8), 1, 2),
    "4bits_cpx": SampleFormat("4bits_cpx", np.dtype(np.uint8), 1, 1),
    # unsigned uint8 I/Q centered on 127.5 (the rtl_tcp / RTL-SDR stream)
    "ubyte_iq": SampleFormat("ubyte_iq", np.dtype(np.uint8), 2),
    # NSR front-end: REAL 2-bit samples, 4 per byte, LSB pair first
    # (Nsr_File_Signal_Source -> unpack_byte_2bit_samples.cc:66-82); real
    # IF samples, Q = 0 (the conditioner's xlating stage recovers baseband)
    "nsr": SampleFormat("nsr", np.dtype(np.uint8), 1, 4),
    # SPIR int32 words: 1-bit I/Q of channel 1 in bits 0/1, +-32767.0
    # (Spir_File_Signal_Source -> unpack_intspir_1bit_samples.cc:60-81)
    "spir": SampleFormat("spir", np.dtype(np.int32), 1),
    # SPIR GSS6450 int32 words, ADC resolution 2 or 4 bits: 8 (resp. 4)
    # complex samples per word, I in the LOW bits of each pair, sample
    # order REVERSED within the word
    # (unpack_spir_gss6450_samples.cc:decode_4bits_word)
    "spir_gss6450_2bit": SampleFormat(
        "spir_gss6450_2bit", np.dtype(np.uint32), 1, 8),
    "spir_gss6450_4bit": SampleFormat(
        "spir_gss6450_4bit", np.dtype(np.uint32), 1, 4),
}


def _signed_k_bits(v: np.ndarray, k: int) -> np.ndarray:
    """Two's-complement reinterpretation of the low k bits."""
    m = 1 << (k - 1)
    v = v & ((1 << k) - 1)
    return v.astype(np.float32) - 2.0 * m * (v >= m)


def convert_to_complex64(raw: np.ndarray, fmt: SampleFormat) -> np.ndarray:
    """Convert a raw item array (1-D, dtype = fmt.dtype) to complex64."""
    if fmt.name == "gr_complex":
        return np.ascontiguousarray(raw, dtype=np.complex64)
    if fmt.name == "2bits_cpx":
        b = raw.astype(np.uint16)
        nibs = np.empty(2 * len(b), dtype=np.uint16)
        nibs[0::2] = (b >> 4) & 0xF          # sample n in the MS nibble
        nibs[1::2] = b & 0xF
        out = np.empty(len(nibs), dtype=np.complex64)
        out.real = _signed_k_bits(nibs & 0x3, 2)
        out.imag = _signed_k_bits((nibs >> 2) & 0x3, 2)
        return out
    if fmt.name == "4bits_cpx":
        b = raw.astype(np.uint16)
        out = np.empty(len(b), dtype=np.complex64)
        out.real = _signed_k_bits(b & 0xF, 4)
        out.imag = _signed_k_bits((b >> 4) & 0xF, 4)
        return out
    if fmt.name == "nsr":
        b = raw.astype(np.uint16)
        out = np.zeros(4 * len(b), dtype=np.complex64)
        for j in range(4):
            out.real[j::4] = _signed_k_bits((b >> (2 * j)) & 0x3, 2)
        return out
    if fmt.name == "spir":
        w = raw.astype(np.int64)
        out = np.empty(len(w), dtype=np.complex64)
        out.real = np.where(w & 1, 32767.0, -32767.0).astype(np.float32)
        out.imag = np.where((w >> 1) & 1, 32767.0, -32767.0).astype(np.float32)
        return out
    if fmt.name.startswith("spir_gss6450"):
        adc_bits = 2 if fmt.name.endswith("2bit") else 4
        spw = 16 // adc_bits                      # samples per int32 word
        w = raw.astype(np.uint64)
        out = np.empty(spw * len(w), dtype=np.complex64)
        for j in range(spw):                      # j-th extracted pair
            iv = _signed_k_bits((w >> (2 * adc_bits * j)) & (
                (1 << adc_bits) - 1), adc_bits)
            qv = _signed_k_bits((w >> (2 * adc_bits * j + adc_bits)) & (
                (1 << adc_bits) - 1), adc_bits)
            # reversed placement within the word (out[spw-1-j])
            out.real[spw - 1 - j::spw] = iv
            out.imag[spw - 1 - j::spw] = qv
        return out
    if fmt.name == "ubyte_iq":
        n = len(raw) // 2
        f = raw[: 2 * n].astype(np.float32) - 127.5
        out = np.empty(n, dtype=np.complex64)
        out.real = f[0::2]
        out.imag = f[1::2]
        return out
    if fmt.items_per_sample == 1:
        out = np.zeros(len(raw), dtype=np.complex64)
        out.real = raw.astype(np.float32)
        return out
    # interleaved I/Q
    n = len(raw) // 2
    f = raw[: 2 * n].astype(np.float32).reshape(n, 2)
    out = np.empty(n, dtype=np.complex64)
    out.real = f[:, 0]
    out.imag = f[:, 1]
    return out
