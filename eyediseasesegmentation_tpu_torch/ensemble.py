"""Multi-checkpoint ensemble inference, the driver (torch port).

Counterpart of the repository's ``ensemble.py``: each run directory gives a
model rebuilt from its ``config.json`` and best checkpoint, wrapped in TTA;
the members' probabilities are averaged on the device, then the AUC-PR, the
threshold search and the mask export run once on the ensemble's. The models
run on the GPU unless ``--device cpu`` is given. ``--sharded`` runs one
member per rank (launch under ``torchrun --nproc_per_node=N``, N at least
the members; ``--device cpu``: gloo); without it, under ``torchrun``, rank
0 alone runs the ensemble. Rank 0 alone writes.

    python -m eyediseasesegmentation_tpu_torch.ensemble \
        --logdirs models/IDRiD/EX/run1 models/IDRiD/EX/run2 \
        --out outputs/ensemble [--tta d4] [--batch_size 2] \
        [--config overrides.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Any, Dict, Optional, Sequence

from .config import TestConfig
from .infer.ensemble import predict
from .parallel import mesh as P


def parse_arg(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--logdirs", nargs="+", required=True,
                        help="run directories (config.json + checkpoints/)")
    parser.add_argument("--out", default="outputs/ensemble")
    parser.add_argument("--tta", default="d4")
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--config", default=None,
                        help="json overriding TestConfig fields")
    parser.add_argument("--sharded", action="store_true",
                        help="one member per rank of the torchrun job "
                             "(psum-mean)")
    parser.add_argument("--device", default=None,
                        help="torch device of the models (default: the GPU)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_arg(argv)
    mesh = P.make_mesh(device=args.device) if args.sharded else None
    if mesh is None and not P.is_main_process():
        return {}
    overrides = {}
    if args.config:
        with open(args.config) as f:
            overrides = json.load(f)
    config = TestConfig.from_dict({**TestConfig().get_all_attributes(),
                                   **overrides}).get_all_attributes()
    result = predict(config, args.logdirs, args.out, tta=args.tta,
                     batch_size=args.batch_size, mesh=mesh,
                     device=args.device)
    logging.info("ensemble result: %s", result)
    return result


if __name__ == "__main__":
    # under torchrun the other ranks log warnings only
    logging.basicConfig(level=logging.INFO if P.is_main_process()
                        else logging.WARNING)
    main()
