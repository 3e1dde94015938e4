"""The 124-group LLNL slab-test opacity dataset.

Port of radiative_transfer_tpu/data/llnl_opacity.py: the port keeps its
own copy of the tables. Physical data for the multigroup LLNL slab
benchmark: 125 group-bound energies (keV, spanning 1e-3 to 30 keV) and
124 group absorption opacities kappa_a (cm^2/g, spanning ~2.1e-2 to 1e6:
optically thick at low energy). The values are the published tables
shipped with the reference miniapp (prm/llnl_slab_test_group_bounds.txt,
prm/llnl_slab_test_group_kappa_a.txt, read by
src/ParameterHandler.cpp:136-198); they are physical data, not code.

`write_tables(dir)` regenerates the whitespace-separated .txt files the
deck loader reads (one value per line, full float64 precision):

    python -m radiative_transfer_tpu_torch.data.llnl_opacity OUTDIR
"""

from __future__ import annotations

import os

import numpy as np

GROUP_BOUNDS = np.array([
    0.001, 0.001229, 0.0015104, 0.0018562, 0.0022812,
    0.0028036, 0.0034455, 0.0042344, 0.005204, 0.0063956,
    0.00786, 0.0096598, 0.011872, 0.01459, 0.017931,
    0.022036, 0.027082, 0.033283, 0.040904, 0.05027,
    0.06178, 0.075926, 0.093311, 0.11468, 0.14093,
    0.17321, 0.21286, 0.2616, 0.32151, 0.39512,
    0.48559, 0.59678, 0.73343, 0.90136, 1.0,
    1.014, 1.0281, 1.0425, 1.057, 1.0718,
    1.0867, 1.1019, 1.1173, 1.1329, 1.1487,
    1.1647, 1.181, 1.1975, 1.2142, 1.2311,
    1.2483, 1.2658, 1.2834, 1.3013, 1.3195,
    1.3379, 1.3566, 1.3755, 1.3947, 1.4142,
    1.434, 1.454, 1.4743, 1.4948, 1.5157,
    1.5369, 1.5583, 1.5801, 1.6021, 1.6245,
    1.6472, 1.6702, 1.6935, 1.7171, 1.7411,
    1.7654, 1.7901, 1.815, 1.8404, 1.8661,
    1.8921, 1.9185, 1.9453, 1.9725, 1.9953,
    2.0893, 2.1878, 2.2909, 2.3988, 2.5119,
    2.6303, 2.7542, 2.884, 3.02, 3.1623,
    3.3113, 3.4674, 3.6308, 3.8019, 3.9811,
    4.1687, 4.3652, 4.5709, 4.7863, 5.0119,
    5.2481, 5.4954, 5.7544, 6.0256, 6.3096,
    6.6069, 6.9183, 7.2444, 7.5858, 7.9433,
    8.3176, 8.7096, 9.1201, 9.5499, 10.701,
    13.151, 16.162, 19.863, 24.411, 30.0,
])  # (125,) keV

GROUP_KAPPA_A = np.array([
    1000000.0, 1000000.0, 1000000.0, 1000000.0, 1000000.0,
    1000000.0, 1000000.0, 1000000.0, 1000000.0, 1000000.0,
    1000000.0, 1000000.0, 1000000.0, 1000000.0, 1000000.0,
    8932.6, 8569.0, 7334.8, 5655.9, 4031.0,
    2710.5, 1769.8, 1184.4, 792.36, 506.05,
    322.98, 206.18, 209.98, 122.94, 75.79,
    49.048, 31.1, 19.467, 11.961, 11.866,
    11.486, 11.116, 10.758, 10.41, 10.071,
    9.7402, 9.4159, 9.0977, 8.7849, 8.4769,
    8.1799, 7.9002, 7.635, 7.3815, 7.1377,
    6.9022, 6.6739, 6.452, 6.2371, 6.0292,
    5.8273, 5.6306, 5.4384, 5.2504, 5.0665,
    4.8859, 4.709, 4.5424, 4.3869, 4.2434,
    4.1166, 4.3104, 15.721, 4.8339, 3.7262,
    3.7581, 4.7057, 33.942, 903.44, 16.153,
    4.0975, 3.4195, 3.3888, 3.9856, 4.3504,
    3.9334, 4.2581, 4.8608, 6.8359, 46.74,
    21.076, 22.814, 19.63, 17.488, 15.903,
    14.42, 12.935, 11.438, 10.14, 9.0471,
    8.0567, 7.1181, 6.2192, 5.4739, 4.8614,
    4.3115, 3.7921, 3.2964, 2.8884, 2.5555,
    2.2581, 1.9785, 1.7128, 1.4958, 1.3199,
    1.1632, 1.0162, 0.87702, 0.76408, 0.67288,
    0.59186, 0.51597, 0.44417, 0.38622, 0.2385,
    0.13092, 0.071433, 0.03867, 0.020756,
])  # (124,) cm^2/g

NUM_GROUPS = GROUP_KAPPA_A.size


def write_tables(outdir: str, prefix: str = "llnl_slab_test") -> tuple:
    """Write the two .txt tables in the deck-loader grammar (a bare
    whitespace-separated stream of doubles)."""
    os.makedirs(outdir, exist_ok=True)
    bounds_path = os.path.join(outdir, prefix + "_group_bounds.txt")
    kappa_path = os.path.join(outdir, prefix + "_group_kappa_a.txt")
    np.savetxt(bounds_path, GROUP_BOUNDS, fmt="%.17g")
    np.savetxt(kappa_path, GROUP_KAPPA_A, fmt="%.17g")
    return bounds_path, kappa_path


if __name__ == "__main__":
    import sys

    print(write_tables(sys.argv[1] if len(sys.argv) > 1 else "prm"))
