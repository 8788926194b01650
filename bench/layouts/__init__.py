"""One file per architecture (a configuration's ``architecture`` key), found
by ``spec.layout_module``: everything of the harness that depends on the
layers a model has.  A new architecture enters by a file here, beside its
``bench/reference/<architecture>.py``; the shared harness names none.

A layout defines:

  WIDTHS          file key -> the port's ``ModelConfig`` field, checked by
                  ``serve.port_config`` beside ``serve.WIDTHS``
  TINY            the configuration's widths in CPU tests (``tests/tiny.py``)
  global_leaves(config)       the ``weights.Leaf`` list outside the layers,
                              the embedding first (a tied model has no
                              second one)
  layer_leaves(config, l)     layer ``l``'s leaves
  program_params(config, draw)  the port's parameter tree, from a
                              ``weights.Draw`` (its ``stack`` allocates a
                              leaf once over many layers)
  is_moe_layer(config, l)     whether layer ``l`` routes (one router call a
                              forward pass)
  n_experts(config)           the routed experts of a MoE layer (the
                              capacity rule's count)
  window(config, l)           the most positions back a token attends at
                              layer ``l``; None: all
  layer_flops(config, l, span)  needed operations (2 a multiply-add) of one
                              token at layer ``l`` that attends to ``span``
                              positions (its window already applied); affine
                              in ``span``, since a prefill sums it over its
                              prompt in one call
  paged_heads(config, l)      (query heads, K/V heads, head size) of layer
                              ``l``'s decode on ``flash_decode_paged``; None
                              where the layer has none
  moe_launches(config, l)     (launches, d, f) of a MoE layer's ``moe_gemm``
                              call: each launch a (d, f) weight an expert

A reference may define ``head(h, g, config, p)`` where the logits are not
``common.head``'s (a tied unembedding, a logit scale); ``check.gaps`` takes
it.
"""
