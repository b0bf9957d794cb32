"""Hand-written Hopper kernels (CUDA C++ sources under ``../csrc``, one
library built on first use by ``build.py``), each beside its plain
PyTorch version and with a launch counter:

* ``coremaint``       — the core-maintenance round statistics
  (``coo_stat``, ``fused_removal_round``, ``fused_promotion_stats``);
* ``segment_ell``     — ELL neighbour reductions (``ell_stat``,
  ``ell_aggregate``);
* ``fm_interaction``  — the DeepFM second-order interaction;
* ``flash_attention`` — blockwise attention forward, GQA;
* ``order``           — label placement's level reductions
  (``place_levels``: ``core/order.py`` ``place_block`` on the card; its
  plain version is ``core/order.py`` ``place_levels_plain``).

``ops`` is the public kernel API (the reference's ``kernels/ops.py``)
and ``ref`` the plain-torch oracles of the reference's ``kernels/ref.py``.
"""
