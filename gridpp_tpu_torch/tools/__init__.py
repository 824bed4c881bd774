"""Tools of gridpp_tpu_torch, each run as `python -m
gridpp_tpu_torch.tools.<name>`:

- `smoke`: every public name once, on the top-level (host) route and on
  the module functions' card route, plus the device entry points;
- `sweep_parity`: every pipeline against its API function over seeds;
- `benchmark_ops`: the per-operator table at gridpp's benchmark sizes, on
  the host route and the card route;
- `scaling`: the parallel layer's strong and weak scaling on CPU ranks;
- `roofline`: each hand-written kernel and OI block against its bound,
  warm and cold, on the card.

The package itself does not import this sub-package.
"""
