"""The port's counterparts of the JAX package's ``scripts/``, one module each, at the same
name, each with ``main(argv=None) -> int`` and run as ``python -m
tpusparse_torch.scripts.<name>``:

  ``run_all``             the one-command reproduce: SpMV, CG with its baselines, sharded CG
  ``sweep``               strong, weak and SpMV sweeps
  ``audit_cg_iteration``  one CG iteration's kernel times against the measured iteration
  ``profile_kernel``      a ``torch.profiler`` trace of SpMV applies per mode
  ``detect_config``       the largest grid the card holds, per mode
  ``sharded_compare``     the sharded CG's buckets, generic ELL kernel against the stencils
  ``format_table``        the format-comparison table and document from SpMV exports
  ``plot_results``        figures of ``run_all``'s and ``sweep``'s exports
  ``plot_roofline``       the SpMV roofline from exports and the ceiling probe

The six that touch a device take ``--platform=cuda|cpu`` (default ``cuda``; without a
card they raise unless ``cpu`` is named), as the CLIs do; ``format_table`` and the two
plots read exports only.  Defaults write under ``results/`` (git-ignored); the committed
H100 exports and figures live in ``docs/h100/``.  matplotlib is imported inside the plots'
``main`` only.  The JAX package's ``probe_ceiling`` and ``probe_onchip_knee`` are
``python -m tpusparse_torch.bench.probes``.
"""
