"""The worked examples on the port, each the counterpart of the script of
the same name in the repo's ``examples/`` and run as

    python -m radiative_transfer_tpu_torch.examples.<name> [--device cuda|cpu]

* ``gray_equilibrium``: the shipped gray deck stays at equilibrium over
  1000 BDF2 steps on the general engine (the reference's GrayTest);
* ``multigroup_correction``: the 4-group comoving-equilibrium deck on
  FastEngine, its Planck and balance tables, the 8 CSVs and the plots;
* ``llnl_production``: the LLNL 124-group deck through auto selection with
  checkpoints and an exact resume;
* ``reference_precision``: the f64 fast engine, the f32 kernel, the
  double-float kernel and the double-float halo engine on one deck, then
  an opacity recovered through the kernel-rate adjoint;
* ``inverse_opacity``: an opacity spectrum recovered by Adam through the
  exact discrete adjoint;
* ``uncertainty``: a Monte-Carlo opacity ensemble against the adjoint's
  linearised spread;
* ``multichip``: ShardedFastEngine and the f32 mesh route on the ranks of
  a torchrun environment against one device.

Each has the script's arguments and defaults plus ``--device`` (``cuda``
by default; without a card it raises, nothing falls back to the CPU) and
a ``main(argv=None) -> dict`` of the figures it prints.
"""
