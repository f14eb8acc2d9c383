"""The repo's result scripts on the port: one module per script of
``scripts/`` that wrote a committed result or an input of the main path,
named like it and run as ``python -m vihmc_torch.scripts.<name>``.

Each takes the script's flags with their defaults plus ``--device`` (the
card unless ``--device cpu``); an output default that would write into a
committed file (under ``assets/`` or ``docs/results/``) lies under
``runs/torch_<name>/`` instead, and an output path under those two
directories is refused.
"""

__all__ = ["canonicalize_operator_draws", "fs_diagnostics_operator", "parity_osf",
           "run_cone_demo", "run_nn_demo", "run_nn_stage12", "run_operator_demo",
           "run_operator_stage12", "run_operator_stage3"]
