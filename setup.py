from setuptools import find_packages, setup

setup(
    name='paintmind-tpu',
    version='0.1.0',
    description='TPU-native JAX rebuild of PaintMind: ViT-VQGAN + MaskGIT '
                'text-to-image',
    license='Apache-2.0',
    packages=find_packages(exclude=('tests', 'tools', 'scripts')),
    package_data={'paintmind_tpu.native': ['fastimage.cpp', 'Makefile'],
                  'paintmind_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'optax', 'orbax-checkpoint', 'einops', 'numpy', 'pillow',
    ],
    extras_require={
        'text': ['transformers'],
        'data': ['pandas', 'datasets'],
        'convert': ['torch'],
    },
)
