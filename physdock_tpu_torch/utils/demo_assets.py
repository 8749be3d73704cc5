"""Locate the demo assets (4-system PoseBusters redocking subset + cached
MSA features + 8-SMILES screening set).

The assets are vendored into the repo under demo/ (≈13 MB: system pkls,
md5-keyed MSA feature pkls, screening receptor, raw receptor.pdb+EJQ.sdf
— the same files as reference demo/, README.md "Demo data") so the
framework demos, benches and gates itself without a reference checkout.
"""

from __future__ import annotations

import os

_REPO_DEMO = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "demo",
)


def demo_root() -> str:
    return _REPO_DEMO


def redocking_systems_dir() -> str:
    return os.path.join(demo_root(), "redocking", "Posebusters_subset")


def redocking_features_dir() -> str:
    return os.path.join(demo_root(), "redocking", "features")


def screening_dir() -> str:
    return os.path.join(demo_root(), "screening")


def system_preparation_dir() -> str:
    return os.path.join(demo_root(), "system_preparation")
