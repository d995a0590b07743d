"""PyTorch/CUDA port of CADDY (playable video generation) for NVIDIA Hopper.

The JAX package ``playablevideogeneration_tpu`` is the reference: every
module here mirrors a module there by path and name, and the tests hold
the two against each other on the same weights and inputs.  This package
imports neither JAX nor the JAX package.

The port so far covers the interactive play route of the model
(``models.caddy.Caddy.play_step`` and ``inference.play_session``) and
training: the training step (``training.trainer.Trainer.train_step``) and
the train CLI (``cli.train``) with its configuration, data pipeline, epoch
loop, checkpoints and in-training evaluation; and what comes after
training: the play and interpolate CLIs, the import of the reference's
``.pth.tar`` checkpoints, and the offline evaluation (``cli.build_evaluation_dataset``,
``cli.evaluate_dataset``).  Three hand-written CUDA
kernels for ``sm_90a`` under ``ops/cuda`` carry them: the ConvLSTM gate
update, forward and backward, and the frozen-BatchNorm + LeakyReLU
epilogue.
"""
