"""Per-signal GNSS constants (GPS L1 C/A, L2C and L5, Galileo E1B and E5a,
GLONASS L1/L2 C/A, BeiDou B1I and B3I).

Reference parity: src/core/system_parameters/GPS_L1_CA.h, GPS_L2C.h,
GPS_L5.h, Galileo_E1.h, Galileo_E5a.h, GLONASS_L1_L2_CA.h, Beidou_B1I.h,
Beidou_B3I.h, gnss_frequencies.h, MATH_CONSTANTS.h.  Values are from the
public ICDs (IS-GPS-200/705, Galileo OS SIS ICD, GLONASS ICD, BeiDou ICD).
"""

from __future__ import annotations

import dataclasses

# --- physical constants (MATH_CONSTANTS.h / GPS_L1_CA.h) ---
SPEED_OF_LIGHT_M_S = 299_792_458.0
GPS_GM = 3.986005e14           # WGS-84 Earth gravitational constant [m^3/s^2]
GPS_OMEGA_EARTH_DOT = 7.2921151467e-5  # WGS-84 Earth rotation rate [rad/s]
GPS_F_RELATIVISTIC = -4.442807633e-10  # s/sqrt(m), clock relativistic term
GALILEO_GM = 3.986004418e14
GALILEO_OMEGA_EARTH_DOT = 7.2921151467e-5
BDS_GM = 3.986004418e14        # CGCS2000 (Beidou_DNAV.h GM)
BDS_OMEGA_EARTH_DOT = 7.2921150e-5     # CGCS2000 earth rotation rate
BDS_GPS_TIME_OFFSET_S = 14.0   # BDT = GPST - 14 s (BDS ICD 3.0 sec 3.2)
GPS_PI = 3.1415926535898       # ICD value of pi used in ephemeris math

# Start offset added to RX time when forming pseudoranges
# (ref: GPS_L1_CA.h:75 GPS_STARTOFFSET_MS = 60.0, used by
#  hybrid_observables_gs.cc:483 compute_pranges).
GNSS_STARTOFFSET_MS = 60.0

# --- carrier frequencies (gnss_frequencies.h) ---
FREQ_L1 = 1575.42e6
FREQ_L2 = 1227.60e6
FREQ_L5 = 1176.45e6
FREQ_E1 = 1575.42e6
FREQ_E5A = 1176.45e6
FREQ_B1I = 1561.098e6
FREQ_B3I = 1268.52e6
# GLONASS FDMA: f = f0 + k * df per channel number k in [-7, 6]
FREQ_G1_GLO = 1602.0e6
DFRQ1_GLO = 0.5625e6
FREQ_G2_GLO = 1246.0e6
DFRQ2_GLO = 0.4375e6


@dataclasses.dataclass(frozen=True)
class SignalSpec:
    """Static description of one GNSS signal component.

    Mirrors the per-signal constant headers of the reference
    (e.g. GPS_L1_CA.h: code rate 1.023e6, 1023 chips, 1 ms period).
    """

    system: str              # 'GPS' | 'Galileo' | 'GLONASS' | 'BeiDou'
    name: str                # e.g. 'L1CA'
    signal_id: str           # 2-char config id used by reference confs: '1C', ...
    carrier_freq_hz: float
    code_rate_chips_s: float
    code_length_chips: int
    code_period_s: float
    # Data/pilot structure
    symbol_rate_sps: float   # navigation symbol rate (after any FEC)
    bit_rate_bps: float      # navigation data bit rate
    secondary_code_length: int = 0
    has_pilot: bool = False

    @property
    def code_period_ms(self) -> float:
        return self.code_period_s * 1e3

    @property
    def chips_per_symbol(self) -> float:
        return self.code_rate_chips_s / self.symbol_rate_sps


GPS_L1_CA = SignalSpec(
    system="GPS", name="L1CA", signal_id="1C",
    carrier_freq_hz=FREQ_L1,
    code_rate_chips_s=1.023e6, code_length_chips=1023, code_period_s=1e-3,
    symbol_rate_sps=50.0, bit_rate_bps=50.0,
)

GPS_L2C = SignalSpec(
    system="GPS", name="L2CM", signal_id="2S",
    carrier_freq_hz=FREQ_L2,
    # L2CM: 10230 chips at 511.5 kchip/s chip-interleaved with L2CL -> 20 ms
    code_rate_chips_s=0.5115e6, code_length_chips=10230, code_period_s=20e-3,
    symbol_rate_sps=50.0, bit_rate_bps=25.0,   # CNAV r=1/2 FEC
)

GPS_L5 = SignalSpec(
    system="GPS", name="L5I", signal_id="L5",
    carrier_freq_hz=FREQ_L5,
    code_rate_chips_s=10.23e6, code_length_chips=10230, code_period_s=1e-3,
    symbol_rate_sps=100.0, bit_rate_bps=50.0,  # CNAV r=1/2 FEC
    secondary_code_length=10, has_pilot=True,  # NH10 on I, NH20 on Q
)

GALILEO_E1B = SignalSpec(
    system="Galileo", name="E1B", signal_id="1B",
    carrier_freq_hz=FREQ_E1,
    code_rate_chips_s=1.023e6, code_length_chips=4092, code_period_s=4e-3,
    symbol_rate_sps=250.0, bit_rate_bps=125.0,  # I/NAV r=1/2 FEC
    secondary_code_length=0, has_pilot=True,    # E1C pilot w/ CS25 secondary
)

GALILEO_E5A = SignalSpec(
    system="Galileo", name="E5aI", signal_id="5X",
    carrier_freq_hz=FREQ_E5A,
    code_rate_chips_s=10.23e6, code_length_chips=10230, code_period_s=1e-3,
    symbol_rate_sps=50.0, bit_rate_bps=25.0,    # F/NAV r=1/2 FEC
    secondary_code_length=20, has_pilot=True,   # CS20 data / CS100 pilot
)

GLONASS_L1_CA = SignalSpec(
    system="GLONASS", name="L1CA", signal_id="1G",
    carrier_freq_hz=FREQ_G1_GLO,   # per-satellite FDMA offset applied at runtime
    code_rate_chips_s=0.511e6, code_length_chips=511, code_period_s=1e-3,
    symbol_rate_sps=100.0, bit_rate_bps=50.0,   # meander 100 sps
)

GLONASS_L2_CA = SignalSpec(
    system="GLONASS", name="L2CA", signal_id="2G",
    carrier_freq_hz=FREQ_G2_GLO,
    code_rate_chips_s=0.511e6, code_length_chips=511, code_period_s=1e-3,
    symbol_rate_sps=100.0, bit_rate_bps=50.0,
)

BEIDOU_B1I = SignalSpec(
    system="BeiDou", name="B1I", signal_id="B1",
    carrier_freq_hz=FREQ_B1I,
    code_rate_chips_s=2.046e6, code_length_chips=2046, code_period_s=1e-3,
    symbol_rate_sps=50.0, bit_rate_bps=50.0,    # D1 NAV (MEO/IGSO), NH20 secondary
    secondary_code_length=20,
)

BEIDOU_B3I = SignalSpec(
    system="BeiDou", name="B3I", signal_id="B3",
    carrier_freq_hz=FREQ_B3I,
    code_rate_chips_s=10.23e6, code_length_chips=10230, code_period_s=1e-3,
    symbol_rate_sps=50.0, bit_rate_bps=50.0,
    secondary_code_length=20,
)

# Registry keyed by the reference's 2-char signal ids
SIGNALS: dict[str, SignalSpec] = {
    s.signal_id: s
    for s in (GPS_L1_CA, GPS_L2C, GPS_L5, GALILEO_E1B, GALILEO_E5A,
              GLONASS_L1_CA, GLONASS_L2_CA, BEIDOU_B1I, BEIDOU_B3I)}


def glonass_fdma_offset_hz(signal_id: str, freq_channel: int) -> float:
    """GLONASS FDMA carrier offset for frequency channel number k in [-7, 6].

    Ref behavior: pcps_acquisition.cc is_fdma() offsets the Doppler grid by
    DFRQ{1,2}_GLO * k for signals '1G'/'2G'.
    """
    if signal_id == "1G":
        return DFRQ1_GLO * freq_channel
    if signal_id == "2G":
        return DFRQ2_GLO * freq_channel
    return 0.0


# --- GPS LNAV framing (GPS_L1_CA.h / IS-GPS-200) ---
GPS_CA_PREAMBLE_BITS = (1, 0, 0, 0, 1, 0, 1, 1)   # 8-bit TLM preamble
GPS_WORD_BITS = 30
GPS_SUBFRAME_BITS = 300
GPS_SUBFRAME_MS = 6000
GPS_WEEK_SECONDS = 604_800
