"""The port's apps: `python -m renderer_tpu_torch.apps.<name>` with name
sandbox (Sponza + Smol Ame, the interactive run_loop), testbox (the real
testbox.glb geometry) or triangle (the hello-world). They run on the card
unless given `device="cpu"`."""
