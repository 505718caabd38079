"""Multi-GPU execution of the port (``paintmind_tpu/parallel/``): one
process per GPU, a (data, model) mesh over the ranks, and explicit
collectives on plain local tensors.

  * ``multihost``: the process group (NCCL on the card, gloo on the CPU)
    from ``torchrun``'s environment;
  * ``mesh``: ``make_mesh``, the batch layout, the placement rules
    (tensor, expert and data parallelism), their inverse gather, and ZeRO-1;
  * ``collectives``: the counted collectives and their autograd forms;
  * ``tensor_parallel``: the forms a carved layer runs;
  * ``pipeline_parallel``: GPipe over the 'model' axis;
  * ``data_parallel``: the gradient all-reduce (or ZeRO-1 reduce-scatter)
    and the global-norm clipping over the mesh.

The JAX package's ``parallel/context.py`` has no counterpart.  It exists
there because XLA's partitioner cannot partition a ``pallas_call``: a
kernel wrapper must find the active mesh and ``shard_map`` itself.  Here
every rank calls the hand-written kernels (K1-K4) on its own local tensors
(its heads, its pipeline stage, its rows), so no kernel needs to know of a
mesh.
"""
