"""The FNO surrogates (FNO2d, FNO1d) and FNO2d's paths through the
hand-written kernels; the training-precision scopes and wrappers; the UQ variants (`variants`, `swag`) and the
Grad-Shafranov surrogates (`ConvAutoencoder`, `INR`)."""

from .cae import ConvAutoencoder
from .fno import (FNO1d, FNO2d, FNO_multi1d, FNO_multi2d, SpectralConv1d, SpectralConv2d,
                  activation_dtype_scope, count_params, precision_scope, train_scope,
                  with_activation_dtype, with_matmul_precision, with_train_precision)
from .fused import fno2d_forward_fused, fused_supported, make_fused_apply, make_fused_train_apply
from .inr import INR
from .swag import SWAG
from .variants import (BayesDense, FNO2dBayesian, bayes_kl_loss, make_dropout_fno, make_mle_fno,
                       mc_dropout_apply)

__all__ = ["FNO1d", "FNO2d", "FNO_multi1d", "FNO_multi2d", "SpectralConv1d", "SpectralConv2d",
           "count_params", "activation_dtype_scope", "precision_scope", "train_scope",
           "with_activation_dtype", "with_matmul_precision", "with_train_precision",
           "fno2d_forward_fused", "fused_supported", "make_fused_apply",
           "make_fused_train_apply",
           "BayesDense", "FNO2dBayesian", "SWAG", "bayes_kl_loss", "make_dropout_fno",
           "make_mle_fno", "mc_dropout_apply", "ConvAutoencoder", "INR"]
