"""Multi-device training and serving: the port of ``gaviko_tpu/parallel/``.

- ``shard``: what a rank holds of a sharded forward (its batch rows, its
  tensor-parallel slice of each split weight), the dropout seed folds that
  keep its bits the whole batch's, and the two Megatron operators;
- ``mesh``: the process group and its data x model layout, the shard rules,
  ZeRO, and the parallel train and eval steps;
- ``infer``: the sharded forward behind ``Predictor(mesh_shape=...)``.
"""
