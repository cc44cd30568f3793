"""Runtime and offline analysis, the counterpart of ``lux_tpu/analysis``:
the recompile sentinel the serving pool counts warmup and serve-phase
compiles with (``sentinel.py``), the tune-artifact tier
(``tuneck.py``, LUX501-504, over the findings of ``core.py``), the
program-contract tier (``gasck.py``, LUX601-606, and its ``gascap.v1``
artifact ``gascap.json``) and the executor registry of the IR tier
(``ir.py::build_executor``). The other lint tiers (AST, threads, IR,
exchange plans, grouped-tail plans, memory) are not ported (ROADMAP
A16)."""
