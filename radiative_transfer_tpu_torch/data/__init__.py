"""Physical data tables: the LLNL slab-test opacities (llnl_opacity.py)."""
