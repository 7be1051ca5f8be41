"""complexity_ms_per_frame.shots: ``complexity_ms_per_frame`` in the cells where it moves
``clip_s_p95`` (the shots mix, whose rate is reported per layer as
``frames_per_s.shots``); read as ``metrics/complexity_ms_per_frame.py`` reads it."""

from benchmark.harness.spec import metric_reader

read = metric_reader("complexity_ms_per_frame")
