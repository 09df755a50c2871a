"""Tests of the benchmark (run them with ``python -m pytest portbench/tests``);
those marked ``cuda`` need a card and skip without one."""
