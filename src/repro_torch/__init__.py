"""PyTorch/CUDA port of the TADOC analytics engine (the JAX package
``repro`` is the reference).  Subpackages mirror it: ``core`` (Sequitur,
flat grammar layout, the packed multi-corpus engine), ``data`` (tokenizer,
synthetic corpora), ``kernels`` (hand-written CUDA kernels for Hopper and
their plain torch versions), ``obs`` (metrics registry, plan tracing)."""
