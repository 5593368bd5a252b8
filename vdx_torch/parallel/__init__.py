"""Training (``train``): the eps-prediction DDPM step over the motion
UNet on one card, in full or through a LoRA adapter. The multi-card half
of vdx's ``vdx.parallel`` (mesh, frame-parallel and ring attention) is not
ported yet (ROADMAP Queue 1 item 14)."""
