"""Profiling and protocol tools of the port, each run as ``python -m
pointwise_torch.tools.<name>`` on the card (``--device cpu`` for the plain
PyTorch path, where every device number is "not measured"):

  attribute_train_step  device time of a training step by operation
  attribute_streaming   a served scene split into host phases and device time
  sweep_seg_conv        forward, dW and dX per layer at the segmentation shapes
  anchor_sweep          the seed-averaged train-then-eval anchor protocol
  time_products         the forward's and dX's product kernels against cuBLAS
  export_checkpoint     a JAX trainer checkpoint's weights as an .npz for
                        --params (CPU only; needs tensorstore)

The first four are ports of the scripts of the same names in scripts/.  The
other scripts there tune Pallas tiles or VMEM and have no counterpart on
the card.
"""
