"""Runtime and offline analysis, the counterpart of ``lux_tpu/analysis``.

Static side (run on the host; the AST and concurrency tiers are
stdlib-only, the plan tiers numpy-only, so ``python -m
lux_tpu_torch.tools.luxlint`` lints the tree in seconds):

- ``core.py`` — the rule engine: ``Rule``/``Finding``, inline
  ``# luxlint: disable=RULE -- reason`` suppressions, JSON and human
  output;
- ``rules.py`` — the AST tier (LUX001-010): host syncs in engine hot
  loops, recompile hygiene, the kernel dtype contract, the LUX_* flag
  registry, clocks, swallowed exceptions, metric, region and ledger
  discipline;
- ``threads.py`` — the concurrency tier (LUX301-305): thread-shared state
  vs lock guards, the cross-file lock-order graph, blocking under a lock,
  unjoined threads, and atomic-publish discipline;
- ``planck.py`` — the grouped-tail plan tier (LUX201-205) over saved
  plan artifacts;
- ``exchck.py`` — the exchange tier's plan rules (LUX401-403, 407) over
  ExchangePlan tables, saved or live; the serving pool audits every
  compact build with it;
- ``tuneck.py`` — the tune-artifact tier (LUX501-504);
- ``gasck.py`` — the program-contract tier (LUX601-606) and its
  ``gascap.v1`` artifact ``gascap.json``;
- ``trace.py`` — torch traces of a step (the counterpart of
  ``jax.make_jaxpr``): aten ops, kernel wrappers, mesh collectives and
  host reads as ordered nodes over storage-versioned buffers;
- ``ir.py`` — the trace tiers over them: the IR rules (LUX101-105), the
  exchange dataflow rules (LUX404-406), the executor registry
  (``build_executor``, the registry matrix), ``luxlint --ir`` and
  ``--exchange``'s runners, and the serving pool's LUX104 audit.

Runtime side: ``sentinel.py`` — ``RecompileSentinel`` (the serving
pool's zero-recompiles-after-warmup evidence) and ``HostTransferGuard``
(fails device->host transfers inside a guarded iteration region).

Not ported (ROADMAP A16): the memory tier (LUX701-706, memck).
"""
