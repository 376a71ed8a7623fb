// The fused explicit-RK ensemble kernel (K1, `erk_body.cuh`, which says
// what it replaces, what bounds it and how it is built) for the six
// tableaus of the reference besides tsit5 and dopri5 (`erk_ensemble.cu`):
// rkck54, bs3, rkf45, rk4 (fixed dt only: it has no error estimate), vern7
// (the paper's GPUVern7) and gbs10, each in its no-event, no-data form for
// the four registered right-hand sides, float32 and float64.  Every one but
// bs3 lacks FSAL, and none has a free interpolant, so the dense output is
// cubic Hermite on f(u_new), evaluated once an accepted step, by the
// reference's design.  The sums stream (`stream_sums`), so gbs10's 26
// stages need not live in registers at once.  bs3, rkf45 and rk4 leave
// nvcc free to contract (`Contracting`), as tsit5's and dopri5's no-event
// forms do.  rkck54, vern7 and gbs10 round every operation alone
// (`rounded`, arith.cuh's `Rounded`, the right-hand side too) and so equal
// the plain version bit for bit: contracted, they missed the parity
// phase's bar on an H100 (f64 Lorenz, 4096 lanes, rtol 1e-8 from dt0 1e-3:
// rkck54's states 3.1e-10 from the plain version's, vern7's and gbs10's
// counts on 32 and 141 lanes; their first steps' error estimates sit at the
// rounding level, so the step sizes follow the rounding; PERF.md §6).
// Their event and data forms are not compiled here: they run in the
// units `repro_torch.translate` generates from the same body.

#include "erk_body.cuh"

namespace repro_erk {

// ---------------------------------------------------------------------------
// Tableaus (src/repro_torch/core/tableaus.py; a test holds these equal,
// gbs10's too, which the reference builds from exact rationals).
// ---------------------------------------------------------------------------

struct Rkck54 {
  static constexpr int stages = 6;
  static constexpr bool fsal = false, stream_sums = true;
  static constexpr bool rounded = true;
  static constexpr bool free_interp = false;
  static constexpr int embedded_order = 4;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[6][6] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.2, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.075, 0.225, 0.0, 0.0, 0.0, 0.0},
        {0.3, -0.9, 1.2, 0.0, 0.0, 0.0},
        {-0.2037037037037037, 2.5, -2.5925925925925926, 1.2962962962962963,
         0.0, 0.0},
        {0.029495804398148147, 0.341796875, 0.041594328703703706,
         0.40034541377314814, 0.061767578125, 0.0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[6] = {
        0.09788359788359788, 0.0, 0.4025764895330113, 0.21043771043771045, 0.0,
        0.2891022021456804};
    return B[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double BT[6] = {
        -0.004293774801587311, 0.0, 0.018668586093857853,
        -0.034155026830808066, -0.019321986607142856, 0.03910220214568039};
    return BT[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[6] = {
        0.0, 0.2, 0.3, 0.6, 1.0, 0.875};
    return C[i];
  }
};

struct Bs3 {
  static constexpr int stages = 4;
  static constexpr bool fsal = true, stream_sums = true;
  static constexpr bool rounded = false;
  static constexpr bool free_interp = false;
  static constexpr int embedded_order = 2;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[4][4] = {
        {0.0, 0.0, 0.0, 0.0},
        {0.5, 0.0, 0.0, 0.0},
        {0.0, 0.75, 0.0, 0.0},
        {0.2222222222222222, 0.3333333333333333, 0.4444444444444444, 0.0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[4] = {
        0.2222222222222222, 0.3333333333333333, 0.4444444444444444, 0.0};
    return B[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double BT[4] = {
        -0.06944444444444448, 0.08333333333333331, 0.1111111111111111, -0.125};
    return BT[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[4] = {
        0.0, 0.5, 0.75, 1.0};
    return C[i];
  }
};

struct Rkf45 {
  static constexpr int stages = 6;
  static constexpr bool fsal = false, stream_sums = true;
  static constexpr bool rounded = false;
  static constexpr bool free_interp = false;
  static constexpr int embedded_order = 4;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[6][6] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.25, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.09375, 0.28125, 0.0, 0.0, 0.0, 0.0},
        {0.8793809740555303, -3.277196176604461, 3.3208921256258535, 0.0, 0.0,
         0.0},
        {2.0324074074074074, -8.0, 7.173489278752436, -0.20589668615984405,
         0.0, 0.0},
        {-0.2962962962962963, 2.0, -1.3816764132553607, 0.4529727095516569,
         -0.275, 0.0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[6] = {
        0.11851851851851852, 0.0, 0.5189863547758284, 0.5061314903420167,
        -0.18, 0.03636363636363636};
    return B[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double BT[6] = {
        0.002777777777777782, 0.0, -0.02994152046783627, -0.029199893673577892,
        0.020000000000000018, 0.03636363636363636};
    return BT[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[6] = {
        0.0, 0.25, 0.375, 0.9230769230769231, 1.0, 0.5};
    return C[i];
  }
};

struct Rk4 {
  static constexpr int stages = 4;
  static constexpr bool fsal = false, stream_sums = true;
  static constexpr bool rounded = false;
  static constexpr bool free_interp = false;
  static constexpr int embedded_order = 4;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[4][4] = {
        {0.0, 0.0, 0.0, 0.0},
        {0.5, 0.0, 0.0, 0.0},
        {0.0, 0.5, 0.0, 0.0},
        {0.0, 0.0, 1.0, 0.0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[4] = {
        0.16666666666666666, 0.3333333333333333, 0.3333333333333333,
        0.16666666666666666};
    return B[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double BT[4] = {
        0.0, 0.0, 0.0, 0.0};
    return BT[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[4] = {
        0.0, 0.5, 0.5, 1.0};
    return C[i];
  }
};

struct Vern7 {
  static constexpr int stages = 10;
  static constexpr bool fsal = false, stream_sums = true;
  static constexpr bool rounded = true;
  static constexpr bool free_interp = false;
  static constexpr int embedded_order = 6;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[10][10] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.005, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {-1.0767901234565735, 1.1856790123454624, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0},
        {0.040833333333336864, 0.0, 0.12249999999999647, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0},
        {0.6389139236256102, 0.0, -2.4556726382238203, 2.2722587145982103, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0},
        {-2.6615773750273117, 0.0, 10.804513886491288, -8.353914657424742,
         0.8204875949589865, 0.0, 0.0, 0.0, 0.0, 0.0},
        {6.067741434695297, 0.0, -24.711273635906824, 20.42751793078589,
         -1.9061579788134801, 1.0061722492391174, 0.0, 0.0, 0.0, 0.0},
        {12.054670076247431, 0.0, -49.754784950450635, 41.14288863859173,
         -4.4617601499684865, 2.0423348222341633, -0.0983484366541985, 0.0,
         0.0, 0.0},
        {10.138146522844547, 0.0, -42.64113603157068, 35.76384003980545,
         -4.348022840378171, 2.009862268369773, 0.3487490460336382,
         -0.2714390051045587, 0.0, 0.0},
        {-45.030072034298676, 0.0, 187.3272437654589, -154.02882369350186,
         18.56465306347536, -7.141809679295079, 1.3088085781613787, 0.0, 0.0,
         0.0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[10] = {
        0.04715561848627767, 0.0, 0.0, 0.257505642984316, 0.2621665397743865,
        0.15216092656729885, 0.49399691700248516, -0.2943031171395947,
        0.08131747232483061, 0.0};
    return B[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double BT[10] = {
        0.002548988715029059, 0.0, 0.0, -0.009665891129052029,
        0.04209735781365781, -0.06673399842882516, 0.2652154308245583,
        -0.29453153722512393, 0.0813805859745605, -0.02031093654480414};
    return BT[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[10] = {
        0.0, 0.005, 0.10888888888888888, 0.16333333333333333, 0.4555,
        0.6095094489982205, 0.884, 0.925, 1.0, 1.0};
    return C[i];
  }
};

struct Gbs10 {
  static constexpr int stages = 26;
  static constexpr bool fsal = false, stream_sums = true;
  static constexpr bool rounded = true;
  static constexpr bool free_interp = false;
  static constexpr int embedded_order = 8;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[26][26] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.25, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.16666666666666666, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0},
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.3333333333333333, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0},
        {0.16666666666666666, 0.0, 0.0, 0.0, 0.0, 0.0, 0.3333333333333333, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0},
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.3333333333333333, 0.0, 0.3333333333333333,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0},
        {0.16666666666666666, 0.0, 0.0, 0.0, 0.0, 0.0, 0.3333333333333333, 0.0,
         0.3333333333333333, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.125, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.125, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0, 0.25,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.125, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0,
         0.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0, 0.25,
         0.0, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.125, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.25, 0.0,
         0.25, 0.0, 0.25, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.2, 0.0, 0.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.2, 0.0, 0.2, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.2, 0.0, 0.2, 0.0, 0.2, 0.0, 0.0, 0.0, 0.0},
        {0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.2, 0.0, 0.2, 0.0, 0.2, 0.0, 0.0, 0.0},
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.2, 0.0, 0.2, 0.0, 0.2, 0.0, 0.2, 0.0, 0.0},
        {0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0, 0.0, 0.0, 0.0, 0.2, 0.0, 0.2, 0.0, 0.2, 0.0, 0.2, 0.0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[26] = {
        0.0, 0.00011574074074074075, -0.033862433862433865, 0.0,
        -0.033862433862433865, 0.48816964285714287, 0.0, 0.48816964285714287,
        0.0, 0.48816964285714287, -1.4447971781305116, 0.0,
        -1.4447971781305116, 0.0, -1.4447971781305116, 0.0,
        -1.4447971781305116, 1.0764577821869488, 0.0, 1.0764577821869488, 0.0,
        1.0764577821869488, 0.0, 1.0764577821869488, 0.0, 1.0764577821869488};
    return B[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double BT[26] = {
        0.0, 0.0028935185185185184, -0.21164021164021163, 0.0,
        -0.21164021164021163, 1.3560267857142858, 0.0, 1.3560267857142858, 0.0,
        1.3560267857142858, -2.257495590828924, 0.0, -2.257495590828924, 0.0,
        -2.257495590828924, 0.0, -2.257495590828924, 1.0764577821869488, 0.0,
        1.0764577821869488, 0.0, 1.0764577821869488, 0.0, 1.0764577821869488,
        0.0, 1.0764577821869488};
    return BT[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[26] = {
        0.0, 0.5, 0.25, 0.5, 0.75, 0.16666666666666666, 0.3333333333333333,
        0.5, 0.6666666666666666, 0.8333333333333334, 0.125, 0.25, 0.375, 0.5,
        0.625, 0.75, 0.875, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9};
    return C[i];
  }
};

template <typename T>
int by_tableau_no_event(int tab_id, int rhs_id, const LaunchArgs& a) {
  switch (tab_id) {
    case 2: return by_rhs<T, Rkck54>(rhs_id, a);
    case 3: return by_rhs<T, Bs3>(rhs_id, a);
    case 4: return by_rhs<T, Rkf45>(rhs_id, a);
    case 5: return by_rhs<T, Rk4>(rhs_id, a);
    case 6: return by_rhs<T, Vern7>(rhs_id, a);
    case 7: return by_rhs<T, Gbs10>(rhs_id, a);
  }
  return -1;
}

}  // namespace repro_erk

// C interface, bound with ctypes by src/repro_torch/kernels/tsit5/kernel.py,
// with the arguments of `erk_ensemble_launch`.  dtype_id: 0 float32, 1
// float64.  tab_id: 2 rkck54, 3 bs3, 4 rkf45, 5 rk4, 6 vern7, 7 gbs10
// (TABLEAU_IDS).  rhs_id: 0 lorenz, 1 sho, 2 ball, 3 decay.  Returns
// cudaGetLastError() after the launch, or -1 for an unknown id.  Launches
// on `stream` and does not synchronise.
extern "C" int erk_tableaus_launch(int dtype_id, int tab_id, int rhs_id,
                                   const void* u0, const void* p,
                                   const void* saveat, int S, int N, double t0,
                                   double tf, double dt0, double rtol,
                                   double atol, int adaptive,
                                   long long max_iters, void* us,
                                   void* u_final, void* t_final, void* stats,
                                   void* stream) {
  const repro_erk::LaunchArgs a{u0,       p,         saveat,    S,
                                N,        t0,        tf,        dt0,
                                rtol,     atol,      adaptive,  max_iters,
                                {0, 0, 0}, us,       u_final,   t_final,
                                stats,    static_cast<cudaStream_t>(stream)};
  switch (dtype_id) {
    case 0: return repro_erk::by_tableau_no_event<float>(tab_id, rhs_id, a);
    case 1: return repro_erk::by_tableau_no_event<double>(tab_id, rhs_id, a);
  }
  return -1;
}

// K2's staged launches in one call, with the arguments of
// `erk_ensemble_staged_launch` (`repro_erk::launch_segments`).
extern "C" int erk_tableaus_staged_launch(
    int dtype_id, int tab_id, int rhs_id, int n, int k, const double* t0s,
    const double* tfs, const int* starts, const void* u0, const void* p,
    const void* saveat, int N, double dt0, double rtol, double atol,
    int adaptive, long long max_iters, void* us, void* u_mid0, void* u_mid1,
    void* u_final, void* t_final, void* stats, void* stream) {
  const repro_erk::LaunchArgs a{u0,       p,         saveat,   0,
                                N,        0.0,       0.0,      dt0,
                                rtol,     atol,      adaptive, max_iters,
                                {0, 0, 0}, us,       u_final,  t_final,
                                stats,    static_cast<cudaStream_t>(stream)};
  return repro_erk::launch_segments(
      a, n, dtype_id ? 8 : 4, k, t0s, tfs, starts, u_mid0, u_mid1,
      [&](const repro_erk::LaunchArgs& s) {
        switch (dtype_id) {
          case 0: return repro_erk::by_tableau_no_event<float>(tab_id, rhs_id,
                                                               s);
          case 1: return repro_erk::by_tableau_no_event<double>(tab_id,
                                                                rhs_id, s);
        }
        return -1;
      });
}
