"""Joint-calling gVCF utilities: compression, overlap cleanup, GQ-band BEDs, de novo qualities.

Counterpart of ``variantcalling_tpu/joint/`` (``gvcf.py``,
``denovo_refinement.py``): host-side algebra over columnar
:class:`~variantcalling_tpu_torch.io.vcf.VariantTable` arrays, with the
native scan's GT, GQ, DP, END and allele counts where the table has them.
"""
