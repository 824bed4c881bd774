"""The benchmark of gridpp_tpu_torch: a data-driven harness (run.py) and
its frozen yardstick (reference/, counts/, metrics/, harness/)."""
