"""Process entrypoints (reference simulator/cmd/{simulator,scheduler}).

Each runs the port on the CUDA card unless ``--device cpu`` asks for the
plain PyTorch versions; without a card and without that flag, the
scheduler service refuses to start ("no CUDA device")."""


def add_device_argument(ap) -> None:
    """The ``--device`` flag every entrypoint takes."""
    ap.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="cuda runs the kernels (the default); cpu runs the plain PyTorch versions",
    )
