from setuptools import find_packages, setup

setup(
    name="style_transfer_tpu",
    version="0.1.0",
    description="TPU-native optimization-based neural style transfer (JAX/XLA/Pallas)",
    packages=find_packages(include=[
        "style_transfer_tpu", "style_transfer_tpu.*",
        "style_transfer_tpu_torch", "style_transfer_tpu_torch.*",
    ]),
    package_data={
        "style_transfer_tpu": ["srgb.icc", "web/static/*"],
        "style_transfer_tpu_torch": ["srgb.icc", "csrc/*.cu", "csrc/*.cuh", "web/static/*"],
    },
    install_requires=[
        "aiohttp",
        "jax",
        "numpy",
        "optax",
        "Pillow",
        "tqdm",
    ],
    entry_points={
        "console_scripts": [
            "style-transfer-tpu=style_transfer_tpu.cli:main",
            "style_transfer_tpu=style_transfer_tpu.cli:main",
            "style-transfer-tpu-torch=style_transfer_tpu_torch.cli:main",
        ],
    },
    python_requires=">=3.10",
)
