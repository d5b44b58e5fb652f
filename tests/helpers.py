"""Shared small-grid model builders for the tests."""

from pathlib import Path

import jax.numpy as jnp

from zeldovich.models.pipeline import Zeldovich
from zeldovich.utils.params import Parameters

ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"


def model(ppd=16, dtype=jnp.float32, **over):
    """A small plain (narray = 2) model; ``over`` overrides parameters."""
    d = dict(
        BoxSize=100.0,
        NP=ppd**3,
        CPD=100,
        ICFormat="RVZel",
        InitialConditionsDirectory="/tmp/ic_packk",
        InitialRedshift=49.0,
        ZD_Seed=97531,
        ZD_NumBlock=2,
        ZD_Pk_scale=1.0,
        ZD_Pk_norm=8.0,
        ZD_Pk_sigma=0.02,
        ZD_Pk_smooth=0.0,
        ZD_Pk_filename=str(ASSETS / "wmap1new.pow"),
        ZD_Version=2,
    )
    d.update(over)
    return Zeldovich(Parameters.from_dict(d), dtype=dtype)


def plt_model(ppd=16, dtype=jnp.float32, **over):
    """The PLT (narray = 4, eigenmodes + rescaling) variant of ``model``."""
    return model(
        ppd,
        dtype,
        ZD_qPLT=1,
        ZD_PLT_filename=str(ASSETS / "eigmodes128"),
        ZD_qPLT_rescale=1,
        ZD_PLT_target_z=5.0,
        **over,
    )
