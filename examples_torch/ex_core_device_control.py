"""Device control: the counterpart of the reference BLAS thread control
(russell_lab/examples/base_auxiliary_blas.rs set_num_threads /
get_num_threads): the port device rule. Every entry point computes on
the card unless given ``device="cpu"``; ``russell_tpu_torch.device``
resolves a name and raises without a card.

Usage: python examples_torch/ex_core_device_control.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch

import russell_tpu_torch

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

dev = russell_tpu_torch.device(device)
print("backend:", dev.type)
print("device count:", torch.cuda.device_count() if dev.type == "cuda" else 1)
print("devices:", [torch.cuda.get_device_name(i)
                   for i in range(torch.cuda.device_count())]
      if dev.type == "cuda" else [str(dev)])
# the lab get_num_threads analog: the host's intra-op threads
assert torch.get_num_threads() >= 1
x = torch.ones(1024, dtype=torch.float64, device=dev)
assert float(x.sum()) == 1024.0
print("device control OK")
