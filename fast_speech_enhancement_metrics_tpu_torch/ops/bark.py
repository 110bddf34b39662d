"""ITU-T P.862 Bark-domain tables and filterbank construction (host-side).

Counterpart of the JAX package's ``ops/bark.py``: the same ITU P.862 16 kHz
tables (data from the ITU reference implementation) and the same float64
numpy derivations of the filterbank, loudness exponents and band widths.
The device side consumes only the resulting float32 matrices and vectors.
"""

from __future__ import annotations

import functools

import numpy as np

# fmt: off
#: Number of contiguous 31.25 Hz FFT bins pooled into each of the 49 Bark bands.
NR_OF_HZ_BANDS_PER_BARK_BAND_16K = np.array([
    1, 1, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1, 2,
    1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4,
    3, 4, 5, 4, 5, 6, 6, 7, 8, 9, 9, 12, 12, 15, 16,
    18, 21, 25, 20])

CENTRE_OF_BAND_BARK_16K = np.array([
    0.078672, 0.316341, 0.636559, 0.961246, 1.290450,
    1.624217, 1.962597, 2.305636, 2.653383, 3.005889,
    3.363201, 3.725371, 4.092449, 4.464486, 4.841533,
    5.223642, 5.610866, 6.003256, 6.400869, 6.803755,
    7.211971, 7.625571, 8.044611, 8.469146, 8.899232,
    9.334927, 9.776288, 10.223374, 10.676242, 11.134952,
    11.599563, 12.070135, 12.546731, 13.029408, 13.518232,
    14.013264, 14.514566, 15.022202, 15.536238, 16.056736,
    16.583761, 17.117382, 17.657663, 18.204674, 18.758478,
    19.319147, 19.886751, 20.461355, 21.043034])

CENTRE_OF_BAND_HZ_16K = np.array([
    7.867213, 31.634144, 63.655895, 96.124611, 129.044968,
    162.421738, 196.259659, 230.563568, 265.338348, 300.588867,
    336.320129, 372.537140, 409.244934, 446.448578, 484.568604,
    526.600586, 570.303833, 619.423340, 672.121643, 728.525696,
    785.675964, 846.835693, 909.691650, 977.063293, 1049.861694,
    1129.635986, 1217.257568, 1312.109497, 1412.501465, 1517.999390,
    1628.894165, 1746.194336, 1871.568848, 2008.776123, 2158.979248,
    2326.743164, 2513.787109, 2722.488770, 2952.586670, 3205.835449,
    3492.679932, 3820.219238, 4193.938477, 4619.846191, 5100.437012,
    5636.199219, 6234.313477, 6946.734863, 7796.473633])

WIDTH_OF_BAND_HZ_16K = np.array([
    15.734426, 31.799433, 32.244064, 32.693359, 33.147385,
    33.606140, 34.069702, 34.538116, 35.011429, 35.489655,
    35.972870, 36.461121, 36.954407, 37.452911, 40.269653,
    42.311859, 45.992554, 51.348511, 55.040527, 56.775208,
    58.699402, 62.445862, 64.820923, 69.195374, 76.745667,
    84.016235, 90.825684, 97.931152, 103.348877, 107.801880,
    113.552246, 121.490601, 130.420410, 143.431763, 158.486816,
    176.872803, 198.314697, 219.549561, 240.600098, 268.702393,
    306.060059, 349.937012, 398.686279, 454.713867, 506.841797,
    564.863770, 637.261230, 794.717285, 931.068359])

WIDTH_OF_BAND_BARK_16K = np.array([
    0.157344, 0.317994, 0.322441, 0.326934, 0.331474,
    0.336061, 0.340697, 0.345381, 0.350114, 0.354897,
    0.359729, 0.364611, 0.369544, 0.374529, 0.379565,
    0.384653, 0.389794, 0.394989, 0.400236, 0.405538,
    0.410894, 0.416306, 0.421773, 0.427297, 0.432877,
    0.438514, 0.444209, 0.449962, 0.455774, 0.461645,
    0.467577, 0.473569, 0.479621, 0.485736, 0.491912,
    0.498151, 0.504454, 0.510819, 0.517250, 0.523745,
    0.530308, 0.536934, 0.543629, 0.550390, 0.557220,
    0.564119, 0.571085, 0.578125, 0.585232])

POW_DENS_CORRECTION_FACTOR_16K = np.array([
    100.000000, 99.999992, 100.000000, 100.000008, 100.000008,
    100.000015, 99.999992, 99.999969, 50.000027, 100.000000,
    99.999969, 100.000015, 99.999947, 100.000061, 53.047077,
    110.000046, 117.991989, 65.000000, 68.760147, 69.999931,
    71.428818, 75.000038, 76.843384, 80.968781, 88.646126,
    63.864388, 68.155350, 72.547775, 75.584831, 58.379192,
    80.950836, 64.135651, 54.384785, 73.821884, 64.437073,
    59.176456, 65.521278, 61.399822, 58.144047, 57.004543,
    64.126297, 54.311001, 61.114979, 55.077751, 56.849335,
    55.628868, 53.137054, 54.985844, 79.546974])

ABS_THRESH_POWER_16K = np.array([
    51286152.000000, 2454709.500000, 70794.593750, 4897.788574, 1174.897705,
    389.045166, 104.712860, 45.708820, 17.782795, 9.772372,
    4.897789, 3.090296, 1.905461, 1.258925, 0.977237,
    0.724436, 0.562341, 0.457088, 0.389045, 0.331131,
    0.295121, 0.269153, 0.257040, 0.251189, 0.251189,
    0.251189, 0.251189, 0.263027, 0.288403, 0.309030,
    0.338844, 0.371535, 0.398107, 0.436516, 0.467735,
    0.489779, 0.501187, 0.501187, 0.512861, 0.524807,
    0.524807, 0.524807, 0.512861, 0.478630, 0.426580,
    0.371535, 0.363078, 0.416869, 0.537032])
# fmt: on

SP_16K = 6.910853e-06  #: power-density normalization (ITU Sp, 16 kHz mode)
SL_16K = 1.866055e-01  #: loudness-scale normalization (ITU Sl, 16 kHz mode)
ZWICKER_POWER = 0.23


def interp_table(values: np.ndarray, nbarks: int) -> np.ndarray:
    """Linearly resample a 49-entry ITU table to ``nbarks`` bands.

    Matches the reference's ``interp`` (fast_se_metrics/utils/bark.py:79-97):
    sample the piecewise-linear interpolant of ``values`` (over index grid
    0..48) at ``linspace(0, 49, nbarks, endpoint=False)``. Identity for
    ``nbarks == 49``.
    """
    positions = np.linspace(0.0, 49.0, nbarks, endpoint=False)
    return np.interp(positions, np.arange(len(values), dtype=np.float64), values)


@functools.lru_cache(maxsize=None)
def bark_constants(nbarks: int = 49, nfreqs: int = 256):
    """Precompute every dense constant the Bark/loudness path needs.

    Returns a dict of float32 NumPy arrays:

    * ``fbank``        (nbarks, nfreqs) 0/1 pooling matrix,
    * ``pow_dens``     (nbarks,) ``pow_dens_correction * Sp``,
    * ``width_bark``   (nbarks,),
    * ``total_width``  scalar ``sum(width_bark[1:])``,
    * ``thresholds``   (nbarks,) absolute hearing threshold power,
    * ``zwicker_exp``  (nbarks,) per-band Zwicker exponent.

    The canonical 49-band / 256-bin mode uses the exact ITU band->bin table;
    other sizes use linear interpolation of the ITU tables and a generated
    rectangular filterbank (same scheme as the reference's BarkFilterBank,
    fast_se_metrics/utils/bark.py:139-161).
    """
    centre_hz = interp_table(CENTRE_OF_BAND_HZ_16K, nbarks)
    width_hz = interp_table(WIDTH_OF_BAND_HZ_16K, nbarks)
    width_bark = interp_table(WIDTH_OF_BAND_BARK_16K, nbarks)
    pow_dens = interp_table(POW_DENS_CORRECTION_FACTOR_16K, nbarks) * SP_16K
    thresholds = interp_table(ABS_THRESH_POWER_16K, nbarks)

    fbank = np.zeros((nbarks, nfreqs), dtype=np.float64)
    if nbarks == 49 and nfreqs == 256:
        edges = np.concatenate([[0], np.cumsum(NR_OF_HZ_BANDS_PER_BARK_BAND_16K)])
        for i in range(nbarks):
            fbank[i, edges[i] : edges[i + 1]] = 1.0
    else:
        prev, bin_width = 0, 8000.0 / nfreqs
        for i in range(nbarks):
            stride = width_hz[i] / bin_width
            centre = centre_hz[i] / bin_width
            start = max(prev, int(np.floor(centre - stride / 2)))
            end = min(nfreqs, int(np.ceil(centre + stride / 2)))
            fbank[i, start:end] = 1.0
            prev = end

    exp = 6.0 / (CENTRE_OF_BAND_BARK_16K + 2.0)
    zwicker_exp = np.clip(exp, 1.0, 2.0) ** 0.15 * ZWICKER_POWER
    if nbarks != 49:
        zwicker_exp = interp_table(zwicker_exp, nbarks)

    return {
        "fbank": fbank.astype(np.float32),
        "pow_dens": pow_dens.astype(np.float32),
        "width_bark": width_bark.astype(np.float32),
        "total_width": float(width_bark[1:].sum()),
        "thresholds": thresholds.astype(np.float32),
        "zwicker_exp": zwicker_exp.astype(np.float32),
    }
