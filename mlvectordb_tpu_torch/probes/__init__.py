"""Probes: measurements on the card that serve no search.

  * ``int8_mma`` — kernels that ask whether the int8 sweep is bound by its convert or by
    its memory traffic (the counterpart of ``benchmarks/probe_int8_mxu.py``);
  * ``out_layout`` — the sweep kernel writing its window mins ``[B, P]`` against
    tile-major (the counterpart of ``benchmarks/probe_out3d.py``);
  * ``tc_error`` — the sweep kernel's dots on the tensor cores against float64, over
    hard inputs (the bound its certificate budgets);
  * ``time_window_min`` — a script that times kernels B4 and B5 at the engine's shape,
    run once per checkout to compare two versions of them in one call.
"""
