"""Network IQ sample sources: custom UDP ingest and the rtl_tcp client.

Reference parity:
- Custom_UDP_Signal_Source (src/algorithms/signal_source/adapters/
  custom_udp_signal_source.h:67 + gr_complex_ip_packet_source.cc): raw IQ
  sample payloads over UDP datagrams, item format configurable.
- RtlTcpSignalSource (rtl_tcp_signal_source.cc + rtl_tcp_commands.cc): the
  rtl_tcp wire protocol — 12-byte "RTL0" header, uint8 centered-127.5 IQ
  stream, and SET_FREQUENCY/SET_SAMPLE_RATE/SET_AGC command frames.

Both collect into host complex64 buffers sized for the receiver's block
loop; the device pipeline is transport-agnostic.
"""

from __future__ import annotations

import socket
import struct

import numpy as np

from .formats import FORMATS, convert_to_complex64


class UdpSignalSource:
    """Bounded UDP IQ collector (Custom_UDP_Signal_Source analogue).

    Datagram payloads are raw samples in `item_type`; packets are assumed
    in order (the reference's IP packet source makes the same assumption
    for its UDP mode)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 item_type: str = "ishort", timeout_s: float = 5.0):
        self.fmt = FORMATS[item_type]
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(timeout_s)
        self._residual = b""                        # partial raw items
        self._pending = np.empty(0, np.complex64)   # converted surplus

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def read(self, count: int) -> np.ndarray:
        """Block until `count` complex samples arrive (or timeout, which
        returns what was collected)."""
        item = np.dtype(self.fmt.dtype).itemsize
        out = [self._pending[:count]]
        have = len(out[0])
        self._pending = self._pending[count:]
        need_bytes = int((count - have) * self.fmt.bytes_per_sample)
        chunks = [self._residual]
        got = len(self._residual)
        while got < need_bytes:
            try:
                data, _ = self._sock.recvfrom(65536)
            except socket.timeout:
                break
            chunks.append(data)
            got += len(data)
        buf = b"".join(chunks)
        usable = (len(buf) // item) * item
        self._residual = buf[usable:]
        x = convert_to_complex64(
            np.frombuffer(buf[:usable], dtype=self.fmt.dtype), self.fmt)
        take = count - have
        out.append(x[:take])
        self._pending = np.concatenate([self._pending, x[take:]]) \
            if len(x) > take else self._pending
        return np.concatenate(out)

    def close(self) -> None:
        self._sock.close()


# rtl_tcp command ids (rtl_tcp_commands.cc)
RTLTCP_SET_FREQUENCY = 0x01
RTLTCP_SET_SAMPLE_RATE = 0x02
RTLTCP_SET_GAIN_MODE = 0x03
RTLTCP_SET_GAIN = 0x04
RTLTCP_SET_AGC_MODE = 0x08


class RtlTcpSignalSource:
    """rtl_tcp protocol client: reads the "RTL0" dongle header, issues
    tuner commands, and converts the uint8 IQ stream (centered on 127.5)
    to complex64 (rtl_tcp_signal_source.cc)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 1234,
                 frequency_hz: float | None = None,
                 sample_rate_hz: float | None = None,
                 agc: bool = True, timeout_s: float = 5.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        hdr = self._recv_exact(12)
        if hdr[:4] != b"RTL0":
            raise IOError(f"not an rtl_tcp server (magic {hdr[:4]!r})")
        self.tuner_type, self.tuner_gain_count = struct.unpack(
            ">II", hdr[4:12])
        if sample_rate_hz is not None:
            self.command(RTLTCP_SET_SAMPLE_RATE, int(sample_rate_hz))
        if frequency_hz is not None:
            self.command(RTLTCP_SET_FREQUENCY, int(frequency_hz))
        self.command(RTLTCP_SET_AGC_MODE, 1 if agc else 0)
        self._fmt = FORMATS["ubyte_iq"]

    def command(self, cmd: int, param: int) -> None:
        self._sock.sendall(struct.pack(">BI", cmd, param))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise IOError("rtl_tcp stream closed")
            buf += chunk
        return buf

    def read(self, count: int) -> np.ndarray:
        raw = np.frombuffer(self._recv_exact(2 * count), dtype=np.uint8)
        return convert_to_complex64(raw, self._fmt)

    def close(self) -> None:
        self._sock.close()
