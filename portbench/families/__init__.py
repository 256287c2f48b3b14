"""Model families: everything about a cell that depends on the
architecture, one module a family.

A configuration file names its family (``"family": "gqa"``), and the
harness loads ``portbench/families/<family>.py`` of the checkout from its
file (``bench.file_module``), with its plain reference
``portbench/reference/<family>.py`` beside it.  A family module gives:

* ``model_config(cfg) -> ModelConfig``: the port's configuration for the
  configuration file ``cfg``;
* ``make_params(cfg, seed, device) -> dict``: the parameter tree, drawn
  from ``seed`` on ``device`` (``portbench.weights.Draw``);
* ``pool_layout(cfg) -> (layers, kv_heads, head_dim)``: what the paged KV
  pool holds a token, for the layers that page their K and V;
* ``engine_kwargs(cfg) -> dict``: keyword arguments the serving engine
  takes beyond the deployment's pages;
* ``prefill_bound_s(cfg, padded) -> {kernel: seconds}``: the least time
  of each kernel in one prefill of ``padded`` tokens;
* ``decode_bound_s(cfg, pages, lens, page, pages_per_seq) -> {kernel:
  seconds}``: the same for one decode step whose rows read ``lens``
  positions through the block tables ``pages``;
* ``model_flops(cfg, prompt_lens, decode_ctx) -> float``: model FLOPs of
  prefilling those prompts and decoding one token at each context.

The driver adds the bounds into ``run.bound_s`` by kernel, where the
``<kernel>_roofline`` readers find them.  The reference module gives
``served_logits(params, cfg, requests, page, precision="fp32") ->
(logits, dropped)`` and imports nothing of the port.
"""
