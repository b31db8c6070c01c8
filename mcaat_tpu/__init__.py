"""mcaat_tpu — assembly-free CRISPR array detection on an accelerator.

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
tool MCAAT (Purpurax/mcaat, C++/OpenMP), re-architected for a JAX accelerator:

* k-mer counting + de Bruijn graph construction as device-side sort +
  segment-reduce over packed integer k-mers (replaces megahit's CX1 sorting
  and BOSS-style succinct dBG — reference ``src/sdbg_build.cpp``).
* The graph is a structure-of-arrays (sorted k-mer table, multiplicity,
  out/in adjacency ``[N, 4]``, validity mask) whose entire query API is
  *batched* (gathers over int32 arrays), replacing the reference's scalar
  per-node SDBG calls (reference ``include/sdbg_build.h``, §2.2-N2 of
  SURVEY.md).
* Graph pruning, start-node selection and read mapping are vectorized
  whole-array passes / batched frontier BFS under ``jit``.
* The small combinatorial stages (spacer ordering, repeat/spacer
  extraction, report filters) run on host with arithmetic faithful to the
  reference (``src/spacer_ordering.cpp``, ``src/tmp_utils.cpp``,
  ``include/post_processing.h``).

64-bit integers are enabled globally: packed 23-mers need 46 bits. Device
code keeps node ids and adjacency in int32 so hot paths stay 32-bit.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: pipeline stages recompile per dataset
# shape, so caching makes repeat runs start hot. JAX reads
# JAX_COMPILATION_CACHE_DIR itself; only without it does the package pick
# a fixed directory inside the checkout (the path is part of the cache
# key, so it must not move between runs).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax.config.update(
        "jax_compilation_cache_dir", os.path.join(_checkout, ".jax_cache")
    )

__version__ = "0.1.0"

K = 23  # k-mer size, fixed by the reference (src/sdbg_build.cpp:216 "-k","23")
