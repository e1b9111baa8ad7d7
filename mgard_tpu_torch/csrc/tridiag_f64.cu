// S1 mass_solve in float64: the instantiation of tridiag.cuh's solve for
// double, compiled beside tridiag.cu (float and the launcher) so that the
// two halves of S1's build run at once.

#include "tridiag.cuh"

template cudaError_t mgard_s1::solve<double>(
    const double*, const double*, const double*, double*, double*, int*,
    int*, const mgard_s1::Geo&, cudaStream_t);
