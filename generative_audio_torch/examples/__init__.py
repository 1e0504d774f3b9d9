"""The port's three examples, each run as a module on the card, or on the
CPU with --device cpu:

    python3 -m generative_audio_torch.examples.enhance_demo [--steps 30]
    python3 -m generative_audio_torch.examples.streaming_demo
    python3 -m generative_audio_torch.examples.nppc_inpainting_demo [--steps 20]

Each makes its own audio or spectrograms; nothing is downloaded."""
