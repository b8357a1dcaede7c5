"""The reference's three demos (SURVEY §1 L4) on gpz_tpu_torch: the port's
copies of demos/demo_sinc.py, demo_2d.py and demo_photoz.py, run as

    python -m gpz_tpu_torch.demos.demo_sinc [--n 10000] [--m 100] ...
    python -m gpz_tpu_torch.demos.demo_2d [--m 50] [--percentage 0.5] ...
    python -m gpz_tpu_torch.demos.demo_photoz [--n 60000] [--m 100] ...

Each module has `run(...) -> dict`, which builds the demo's seeded data,
trains through the package's entry points (`init` -> `train` -> `predict`)
and returns every number the JAX script prints, and `main(argv)`, which
prints them in the JAX script's format. The flags are the JAX scripts',
with `--device` (default cuda; without a CUDA device the default raises
torch's error) in place of `--cpu`; demo_sinc's plot is written only where
`--plot PATH` says.
"""
