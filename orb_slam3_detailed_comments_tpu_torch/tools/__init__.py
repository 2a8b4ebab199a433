"""The repo's tools, run on the port: counterparts of ``scripts/
train_vocab.py``, ``eval_vocab.py``, ``profile_stages.py`` and
``make_dataset_configs.py``. Each is a module with ``main(argv)``:

    python -m orb_slam3_detailed_comments_tpu_torch.tools.<tool> ... [--device cpu]

Each runs on the CUDA card unless ``--device cpu`` is given, and raises
without a card otherwise.
"""
