"""Batched-request serving demo, in the PyTorch port: the counterpart of
``examples/serve_forecaster.py``, a thin client of ``repro_torch.serving``.

Fits a small FL model, publishes it into the serving registry, and replays
next-hour forecast requests for hundreds of unseen consumers through the
padded-bucket batching engine (paper §5.4: deploy to clients with no
compute for training).  Raw watt-hours in, kWh out; ``--clusters k`` routes
each unseen consumer to its nearest-centroid cluster model, ``--int8``
serves quantized weights.  It runs on the CUDA card unless given
``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_forecaster.py
  PYTHONPATH=src python examples/torch_serve_forecaster.py --requests 1024
  PYTHONPATH=src python examples/torch_serve_forecaster.py --clusters 3 --int8
"""
import sys

from repro_torch.launch import serve

# demo-sized defaults, overridable from the command line: user flags are
# appended AFTER the defaults, and argparse lets the last occurrence win
DEFAULTS = ["--train-clients", "16", "--rounds", "20",
            "--requests", "256", "--days", "90"]


def main(argv=None):
    """``launch.serve.main`` with the demo defaults before ``argv``;
    returns its served tickets."""
    return serve.main(DEFAULTS + list(sys.argv[1:] if argv is None
                                      else argv))


if __name__ == "__main__":
    main()
