"""LSMC engine over materialised path panels."""
