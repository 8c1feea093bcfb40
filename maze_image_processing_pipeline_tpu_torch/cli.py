"""The ``maze-ipp-torch`` command-line interface of the PyTorch port.

Counterpart of ``maze_image_processing_pipeline_tpu/cli.py``: ``loki`` runs
the LOKI workload from a YAML task file, ``predict`` the prediction
workload (``semseg`` and ``polytaxo`` are its aliases), and ``config
loki|predict|semseg|polytaxo`` prints the commented default configuration.
"""

from __future__ import annotations

import click

from . import __version__


@click.group()
@click.version_option(version=__version__)
def cli():
    """MAZE image processing pipelines (PyTorch and CUDA)."""


@cli.command()
@click.argument("task_fn", type=click.Path(exists=True))
def loki(task_fn):
    """LOKI (re-)segmentation pipeline."""
    from .loki.pipeline import Runner

    Runner.run(task_fn)


@cli.command()
@click.argument("task_fn", type=click.Path(exists=True))
def predict(task_fn):
    """Predict images using a model (semseg / polytaxo)."""
    from .predict.pipeline import Runner

    Runner.run(task_fn)


@cli.command()
@click.argument("task_fn", type=click.Path(exists=True))
def semseg(task_fn):
    """Semantic segmentation (alias for `predict` with tiling+segmentation)."""
    from .predict.pipeline import Runner

    Runner.run(task_fn)


@cli.command()
@click.argument("task_fn", type=click.Path(exists=True))
def polytaxo(task_fn):
    """Polyhierarchical classification (alias for `predict` with polytaxo)."""
    from .predict.pipeline import Runner

    Runner.run(task_fn)


@cli.command()
@click.argument("module")
def config(module):
    """Generate default configuration (loki | predict)."""
    from .config import generate_yaml_example

    if module == "loki":
        from .loki.config_schema import SegmentationPipelineConfig as Schema
    elif module in ("predict", "semseg", "polytaxo"):
        from .predict.config_schema import PredictionPipelineConfig as Schema
    else:
        raise ValueError(f"Unknown module: {module}")

    print(generate_yaml_example(Schema))


if __name__ == "__main__":
    cli()
