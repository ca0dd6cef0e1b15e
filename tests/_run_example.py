"""Example-runner shim: run an example on the CPU platform."""

import runpy
import sys

import jax

jax.config.update("jax_platforms", "cpu")
runpy.run_path(sys.argv[1], run_name="__main__")
