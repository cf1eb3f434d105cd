"""The sync engine: epipolar residual rows, RANSAC translation
guesser, PreSync delay grid, Sync alternating optimizer, and the
`SyncProblem` API (ref: src/core/)."""
