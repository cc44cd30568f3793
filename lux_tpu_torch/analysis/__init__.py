"""Runtime analysis, the counterpart of ``lux_tpu/analysis``: so far the
recompile sentinel the serving pool counts warmup and serve-phase
compiles with (``sentinel.py``). The lint tiers (IR, exchange plans,
program algebra, memory) are not ported (ROADMAP A16)."""
