"""Running a JAX reference once, for the port's CPU tests.

A reference that runs once on a small input spends nearly all its time in
XLA's compile.  `run_jitted` compiles it at XLA's backend optimization
level 0: the same operations, a quarter to a third less compile CPU than
the default build (its results within float rounding of the default
build's).  It also compiles on one thread, without XLA's fusion emitters
and with its LLVM module in one piece: the default build spreads its
compile over two or more cores, which the tier-1 suite's other workers
need, for about half again as much CPU.  The tier-1 suite runs these files
beside the JAX package's own tests, so their compile CPU lengthens the
whole run.
"""

import jax

COMPILER_OPTIONS = {"xla_backend_optimization_level": 0,
                    "xla_cpu_use_fusion_emitters": False,
                    "xla_cpu_parallel_codegen_split_count": 1}


def compile_level0(fn, *args):
    """fn jitted and compiled at XLA's backend optimization level 0 (with
    COMPILER_OPTIONS) for args' shapes (args are arrays; close over the
    static arguments)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=COMPILER_OPTIONS)


def run_jitted(fn, *args):
    """fn(*args), jitted and compiled at XLA's backend optimization level
    0 (args are arrays; close over the static arguments)."""
    return compile_level0(fn, *args)(*args)
