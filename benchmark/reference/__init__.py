"""The plain reference: the nets' forward, loss, gradients and AdamW in
float32 PyTorch with TF32 off.  It imports nothing of ``pointwise_torch``
and takes nothing the program made: the harness hands both sides the same
inputs and weights."""
