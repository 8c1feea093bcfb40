"""The ``maze-ipp-torch`` command-line interface of the PyTorch port.

Counterpart of ``maze_image_processing_pipeline_tpu/cli.py``: ``loki`` runs
the LOKI workload from a YAML task file and ``config loki`` prints its
commented default configuration. ``predict``, ``semseg`` and ``polytaxo``
are not ported yet (ROADMAP A3) and exit with a message saying so.
"""

from __future__ import annotations

import click

from . import __version__

_NOT_PORTED = (
    "maze-ipp-torch {name}: the predict workload is not ported to PyTorch yet "
    "(ROADMAP A3); run it with the JAX package's `maze-ipp {name}`."
)


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


def _not_ported(name: str):
    @cli.command(name=name)
    @click.argument("task_fn", type=click.Path(exists=True))
    def command(task_fn):
        raise click.ClickException(_NOT_PORTED.format(name=name))

    command.__doc__ = f"Not ported yet (ROADMAP A3): the JAX package's `{name}`."
    return command


predict = _not_ported("predict")
semseg = _not_ported("semseg")
polytaxo = _not_ported("polytaxo")


@cli.command()
@click.argument("module")
def config(module):
    """Generate default configuration (loki)."""
    from .config import generate_yaml_example

    if module == "loki":
        from .loki.config_schema import SegmentationPipelineConfig as Schema
    elif module in ("predict", "semseg", "polytaxo"):
        raise click.ClickException(_NOT_PORTED.format(name=f"config {module}"))
    else:
        raise ValueError(f"Unknown module: {module}")

    print(generate_yaml_example(Schema))


if __name__ == "__main__":
    cli()
