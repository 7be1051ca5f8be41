"""device_idle_pct.shots: ``device_idle_pct`` in the cells where it moves
``clip_s_p95`` (the shots mix, whose rate is reported per layer as
``frames_per_s.shots``); read as ``metrics/device_idle_pct.py`` reads it."""

from benchmark.harness.spec import metric_reader

read = metric_reader("device_idle_pct")
