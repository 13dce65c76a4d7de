"""Operations and bytes of each kernel and of each configuration's model,
counted from shapes by the benchmark's own fixed formulas (copied from the
repository's ``chip_smoke.py`` bounds and ``PERF.md``'s "The bounds"), so a
later change to the program cannot move its own yardstick."""
