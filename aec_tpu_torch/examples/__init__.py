"""The example entry points of ``examples/``, on the port
(``python -m aec_tpu_torch.examples.<name>``):

- ``train_synthetic``: LittleNet trained behind stage 1 (K1) on synthetic
  scenes made on the card, the recipe of every shipped stage-2 checkpoint;
- ``demo_two_stage``: one scene through both stages, wavs and a report;
- ``serving_loop``: the serving step (K3) once per 16 ms block, with block
  latency percentiles and the live ERLE monitor;
- ``make_corpus``: the wav corpus ``cli/prepare_data`` packs (numpy only).

Each keeps its JAX script's flags and prints; those that use a device run on
the card unless ``--device cpu`` is passed.
"""
