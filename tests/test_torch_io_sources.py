"""Twins of tests/test_io_sources.py's LabSat and network cases for the
port's copies (io/labsat.py, io/network.py): LabSat 3 at 2 and 4 bits a
sample, its dual-channel refusal, the UDP source over a localhost
datagram socket and the rtl_tcp client against a mock server on
127.0.0.1.  The block registry's notes name these classes."""

import socket
import struct
import threading

import numpy as np
import pytest

import gnss_sdr_1_tpu.io.labsat as jlabsat
from gnss_sdr_1_tpu_torch.io import (LabsatSource, RtlTcpSignalSource,
                                     UdpSignalSource)
from gnss_sdr_1_tpu_torch.io.labsat import (LabsatHeaderError,
                                            decode_labsat_words)
from gnss_sdr_1_tpu_torch.io.network import RTLTCP_SET_FREQUENCY
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_udp_signal_source_roundtrip():
    src = UdpSignalSource(port=0, item_type="ishort", timeout_s=3.0)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    want = (np.arange(600) - 300).astype(np.int16)
    # three datagrams, one with an odd split across a sample boundary
    payload = want.tobytes()
    for seg in (payload[:400], payload[400:402], payload[402:]):
        tx.sendto(seg, ("127.0.0.1", src.port))
    x = src.read(300)
    assert len(x) == 300
    np.testing.assert_array_equal(x.real.astype(np.int16), want[0::2])
    np.testing.assert_array_equal(x.imag.astype(np.int16), want[1::2])
    src.close()
    tx.close()


def test_rtl_tcp_client_protocol():
    """Mock rtl_tcp server: header handshake, command reception, stream
    conversion (uint8 centred on 127.5)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    got_cmds = []

    def serve():
        conn, _ = srv.accept()
        conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
        for _ in range(3):          # the three configuration commands
            got_cmds.append(struct.unpack(">BI", conn.recv(5)))
        iq = np.array([127, 127, 255, 0, 0, 255], dtype=np.uint8)
        conn.sendall(iq.tobytes())
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    cli = RtlTcpSignalSource(port=port, frequency_hz=1575.42e6,
                             sample_rate_hz=2.048e6)
    assert cli.tuner_type == 5 and cli.tuner_gain_count == 29
    x = cli.read(3)
    t.join(timeout=5)
    assert (RTLTCP_SET_FREQUENCY, 1575420000) in got_cmds
    np.testing.assert_allclose(
        x, [-0.5 - 0.5j, 127.5 - 127.5j, -127.5 + 127.5j])
    cli.close()
    srv.close()


def test_rtl_tcp_refuses_another_server():
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        conn.sendall(b"HTTP" + bytes(8))
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    with pytest.raises(IOError, match="not an rtl_tcp server"):
        RtlTcpSignalSource(port=srv.getsockname()[1])
    t.join(timeout=5)
    srv.close()


def _labsat_header(bits_per_sample=2, channel_selector=1):
    hdr = bytearray(1024)
    hdr[8:11] = b"LS3"
    hdr[11] = 1                               # sub version
    struct.pack_into("<i", hdr, 12, 1024)     # header bytes
    struct.pack_into("<H", hdr, 16, 2)        # section id 2
    struct.pack_into("<i", hdr, 18, 32)       # section length
    hdr[22] = 2                               # ref clock: external 10 MHz
    hdr[23] = bits_per_sample
    hdr[24] = channel_selector
    hdr[25] = 1                               # quantization
    hdr[26] = 0                               # channel A: GPS
    hdr[27] = 1                               # channel B: GLONASS
    return bytes(hdr)


def test_labsat3_2bit_source(tmp_path):
    """LabSat3 single-channel 2-bit decode: 8 samples per int16, I/Q from
    bit pairs MSB-first, 0/1 -> -1/+1, multi-file sequences chained; the
    JAX package's source reads the same samples."""
    word = 0b1000000000000011
    f0 = tmp_path / "cap_0000.LS3"
    f0.write_bytes(_labsat_header(2) + struct.pack("<H", word))
    f1 = tmp_path / "cap_0001.LS3"
    f1.write_bytes(struct.pack("<H", word))
    src = LabsatSource(str(tmp_path / "cap"))
    assert src.header["version"] == 3
    assert src.header["constellation_a"] == "GPS"
    assert src.n_samples == 16                # 8 per word, 2 files
    x = src.read(0, 16)
    assert x[0] == np.complex64(1.0 - 1.0j)
    assert x[7] == np.complex64(1.0 + 1.0j)
    assert np.allclose(x[1:7], -1.0 - 1.0j)
    assert np.allclose(x[:8], x[8:])          # second file = same word
    assert np.allclose(src.read(6, 4), [x[6], x[7], x[0], x[1]])
    ref = jlabsat.LabsatSource(str(tmp_path / "cap"))
    assert ref.header == src.header
    np.testing.assert_array_equal(ref.read(0, 16), x)


def test_labsat3_4bit_decode():
    """4-bit component mapping 00->0.5, 01->1.5, 10->-1.5, 11->-0.5."""
    w = np.array([0b0010_0000_0000_0000], dtype=np.int64)
    x = decode_labsat_words(w, 4)
    assert x[0] == np.complex64(1.5 + 0.5j)
    w = np.array([0b1110_0000_0000_0000], dtype=np.int64)
    x = decode_labsat_words(w, 4)
    assert x[0] == np.complex64(-0.5 - 1.5j)
    words = np.random.default_rng(4).integers(0, 1 << 16, 64)
    for bits in (2, 4):
        np.testing.assert_array_equal(decode_labsat_words(words, bits),
                                      jlabsat.decode_labsat_words(words,
                                                                  bits))


def test_labsat_dual_channel_rejected(tmp_path):
    f0 = tmp_path / "dual_0000.LS3"
    f0.write_bytes(_labsat_header(2, channel_selector=0))
    with pytest.raises(LabsatHeaderError):
        LabsatSource(str(tmp_path / "dual"))


def test_factory_source_notes_name_the_ports_classes():
    import gnss_sdr_1_tpu_torch
    from gnss_sdr_1_tpu_torch.runtime import factory

    for name in ("Custom_UDP_Signal_Source", "RtlTcp_Signal_Source",
                 "Labsat_Signal_Source"):
        path = factory.resolve(name).note.split(" ")[0]
        mod, cls = path.rsplit(".", 1)
        obj = gnss_sdr_1_tpu_torch
        for part in mod.split("."):
            obj = getattr(obj, part)
        assert isinstance(getattr(obj, cls), type), path
