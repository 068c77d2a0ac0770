"""``tests/test_torch_reshard.py``'s tests on the mesh pair (1, 4, 1) ->
(1, 2, 1) (``PAIRS['1x4x1-1x2x1']``), collected here so that xdist's
--dist loadfile gives the pair's spawned world and JAX's run of it a
worker of their own. The gates are that file's."""

from test_torch_reshard import (  # noqa: F401 (collected from here)
    pytest_generate_tests,
    test_round_trip_is_bit_equal,
    test_resumed_step_matches_the_uninterrupted_one,
    test_leaves_move_between_layouts,
    test_replicas_are_bit_equal_before_the_save,
    test_replica_parts_hold_no_params,
    test_old_form_parts_still_restore,
    test_restore_matches_jax,
)

PAIR_NAMES = ('1x4x1-1x2x1',)
