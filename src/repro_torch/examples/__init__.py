"""The port's entry points: the ten scripts of the repository's
``examples/``, each run as ``python -m repro_torch.examples.<name>``.

Every module has ``main(argv) -> int`` with the script's flags plus
``--device`` (``"cuda"`` by default; ``--device cpu`` to run without a
card). What they write goes under :data:`RESULTS`.
"""
import os

RESULTS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                       "results", "torch"))
