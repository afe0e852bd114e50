"""The paper's task end to end on the port, twins of the JAX package's
drivers outside `src/`:

  train_detector   examples/train_detector.py: QAT of both designs, then
                   the five-column Table II population ablation
  quickstart       examples/quickstart.py: one ternary layer on the
                   1024x1024 crossbar, effect by effect
  paper_tables     the paper figure and table functions of
                   benchmarks/paper_tables.py

Each runs with `python -m repro_torch.examples.<name>`, on the card unless
`--device cpu` asks for the CPU.
"""
