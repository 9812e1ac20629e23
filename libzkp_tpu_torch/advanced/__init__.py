"""Advanced layer: composite proofs, batching, cache, metrics, benchmarks.

Port of the JAX package's ``libzkp_tpu/advanced`` (the Rust reference's
``src/advanced/`` layer, SURVEY.md §1): orchestration over single proofs.
Re-exports everything like ``advanced/mod.rs``.
"""

from .batch import (  # noqa: F401
    batch_add_consistency_proof,
    batch_add_equality_proof,
    batch_add_improvement_proof,
    batch_add_membership_proof,
    batch_add_range_proof,
    batch_add_threshold_proof,
    clear_batch,
    create_proof_batch,
    export_batch_to_file,
    get_batch_status,
    import_batch_from_file,
    open_batch_from_store,
    process_batch,
    refresh_batch_from_store,
)
from .batch_store import (  # noqa: F401
    get_batch_store_dir,
    list_batch_ids_in_store,
    set_batch_store_dir,
)
from .composite import (  # noqa: F401
    create_composite_proof,
    create_proof_with_metadata,
    extract_proof_metadata,
    verify_composite_proof,
    verify_composite_proof_integrity_only,
)
from .misc import (  # noqa: F401
    benchmark_proof_generation,
    benchmark_proof_generation_numeric,
    clear_cache,
    get_cache_stats,
    get_performance_metrics,
    get_proof_info,
    is_snark_setup_initialized,
    prove_equality_advanced,
    prove_range_cached,
    prove_threshold_optimized,
    set_snark_key_dir,
    validate_proof_chain,
    verify_proofs_parallel,
)
