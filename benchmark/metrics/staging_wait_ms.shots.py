"""staging_wait_ms.shots: ``staging_wait_ms`` in the cells where it moves
``clip_s_p95`` (the shots mix, whose rate is reported per layer as
``frames_per_s.shots``); read as ``metrics/staging_wait_ms.py`` reads it."""

from benchmark.harness.spec import metric_reader

read = metric_reader("staging_wait_ms")
