"""vdx's ``vdx.parallel`` on PyTorch: the mesh and its axis bindings
(``mesh``), multi-process bring-up (``distributed``), ring attention
(``ring_attention``), frame-sharded denoisers (``frame_parallel``) and
training on one card (``train``). Window-parallel context, the data axis,
the train step over a mesh and tensor parallelism come with the next
slice of the port (ROADMAP Queue 1 item 14, steps 7-8)."""
