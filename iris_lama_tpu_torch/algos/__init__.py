"""SLAM and localisation drivers."""
