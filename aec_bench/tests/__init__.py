"""CPU tests of the benchmark (``python -m pytest aec_bench/tests``); the
tests that need a card are marked ``cuda`` and skip without one."""
