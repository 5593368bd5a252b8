"""vdx's ``vdx.parallel`` on PyTorch: the mesh, its axis bindings, the
differentiable collectives and ``param_sharding_rules`` (``mesh``),
multi-process bring-up (``distributed``), ring attention
(``ring_attention``), frame-sharded denoisers (``frame_parallel``),
tensor-parallel execution (``tensor_parallel``) and training on one card
or over the (data, frames, tensor) mesh (``train``)."""
