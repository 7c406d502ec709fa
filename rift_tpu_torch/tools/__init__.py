"""The experiment protocols and result tools of the repository, on the
port (counterparts of the scripts in the repository's `tools/`, which run
on the JAX package). Each runs as `python -m rift_tpu_torch.tools.<name>`
with the JAX tool's arguments, defaults, stages and output layout; runs go
on CUDA unless `--cpu` is given, and outputs go under `log/torch/<tool>`
and `results/torch/<tool>/` of the checkout.

  check_eval          validate `simulation_results.json` files
  merge_statistics    the paper's metric table, mean ± std across seeds
  runs                list, show and compare tracked run directories
  quality_experiment  the Table-1 protocol: pretrain, fine-tunes, eval, merge
  topology_eval       the expert ego on lane-change routes of the grid town
  ego_zoo_experiment  the learned-ego protocol: collect, PlanT and E2E BC, eval
"""

import os

# the checkout: the tools' default outputs live under it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
