// The fused explicit-RK ensemble kernel (K1, `erk_body.cuh`, which says
// what it replaces, what bounds it and how it is built) for tsit5 and
// dopri5: the no-event form (nvcc free to contract, `Contracting`), the
// event forms of the (RHS, event) pairs of `by_event` and the data forms of
// `by_data`, every operation rounded alone (`Rounded`).  The other six
// tableaus of the reference are compiled in `erk_tableaus.cu`, from the
// same body, so that the two build in parallel and these instantiations
// keep their code (tools/parent_check.py holds both their outputs and their
// registers to earlier builds).

#include "erk_body.cuh"

namespace repro_erk {

// ---------------------------------------------------------------------------
// Tableaus (src/repro_torch/core/tableaus.py; a test holds these equal).
// The arrays are locals of constexpr functions so that device code may read
// them in constant expressions.
// ---------------------------------------------------------------------------

struct Tsit5 {
  static constexpr int stages = 7;
  static constexpr bool fsal = true, stream_sums = false;
  static constexpr bool rounded = false;
  static constexpr bool free_interp = true;
  static constexpr int embedded_order = 4;
  // the free interpolant's weights (dense_output)
  template <class A, typename T>
  __device__ __forceinline__ static void bpoly(T t, T (&w)[7]) {
    repro_erk::tsit5_bpoly<A>(t, w);
  }
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[7][7] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.161, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {-0.008480655492356989, 0.335480655492357, 0.0, 0.0, 0.0, 0.0, 0.0},
        {2.8971530571054935, -6.359448489975075, 4.3622954328695815, 0.0, 0.0,
         0.0, 0.0},
        {5.325864828439257, -11.748883564062828, 7.4955393428898365,
         -0.09249506636175525, 0.0, 0.0, 0.0},
        {5.86145544294642, -12.92096931784711, 8.159367898576159,
         -0.07158497328140101, -0.028269050394068383, 0.0, 0.0},
        {0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774, 0.0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[7] = {0.09646076681806523, 0.01, 0.4798896504144996,
                             1.379008574103742,   -3.290069515436081,
                             2.324710524099774,   0.0};
    return B[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double BT[7] = {-0.001780011052225777, -0.0008164344596567469,
                              0.007880878010261995,  -0.1447110071732629,
                              0.5823571654525552,    -0.45808210592918697,
                              0.015151515151515152};
    return BT[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[7] = {0.0, 0.161, 0.327, 0.9, 0.9800255409045097,
                             1.0, 1.0};
    return C[i];
  }
};

struct Dopri5 {
  static constexpr int stages = 7;
  static constexpr bool fsal = true, stream_sums = false;
  static constexpr bool rounded = false;
  static constexpr bool free_interp = false;
  static constexpr int embedded_order = 4;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[7][7] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.075, 0.225, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.9777777777777777, -3.7333333333333334, 3.5555555555555554, 0.0, 0.0,
         0.0, 0.0},
        {2.9525986892242035, -11.595793324188385, 9.822892851699436,
         -0.2908093278463649, 0.0, 0.0, 0.0},
        {2.8462752525252526, -10.757575757575758, 8.906422717743473,
         0.2784090909090909, -0.2735313036020583, 0.0, 0.0},
        {0.09114583333333333, 0.0, 0.44923629829290207, 0.6510416666666666,
         -0.322376179245283, 0.13095238095238096, 0.0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[7] = {0.09114583333333333, 0.0, 0.44923629829290207,
                             0.6510416666666666,  -0.322376179245283,
                             0.13095238095238096, 0.0};
    return B[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double BT[7] = {0.0012326388888888873, 0.0,
                              -0.004252770290506136, 0.036979166666666674,
                              -0.05086379716981132,  0.04190476190476192,
                              -0.025};
    return BT[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[7] = {0.0, 0.2, 0.3, 0.8, 0.8888888888888888, 1.0, 1.0};
    return C[i];
  }
};


// The registered (RHS, event) pairs (EVENT_PAIRS in
// src/repro_torch/kernels/tsit5/kernel.py).
template <typename T, class Tab>
int by_event(int rhs_id, int event_id, const LaunchArgs& a) {
  if (rhs_id == 2 && event_id == repro_ev::BallBounce::kEventId)
    return launch<T, Tab, Ball, repro_ev::BallBounce>(a);
  if (rhs_id == 3 && event_id == repro_ev::DecayHalf::kEventId)
    return launch<T, Tab, Decay, repro_ev::DecayHalf>(a);
  return -1;
}

// The data functors (DATA_LAYOUTS in src/repro_torch/kernels/tsit5/
// kernel.py): the forced oscillator in each mode, and in gather mode with
// the level event (DATA_EVENT_PAIRS).
template <typename T, class Tab>
int by_data(int rhs_id, int event_id, const LaunchArgs& a) {
  using repro_data::Tables;
  using repro_ev::NoEvent;
  if (event_id == 0) {
    switch (rhs_id) {
      case 4: return launch<T, Tab, ForcedOsc<repro_data::kGather>, NoEvent,
                            Tables>(a);
      case 5: return launch<T, Tab, ForcedOsc<repro_data::kOneHot>, NoEvent,
                            Tables>(a);
      case 6: return launch<T, Tab, ForcedOsc<repro_data::kCubic>, NoEvent,
                            Tables>(a);
    }
    return -1;
  }
  if (rhs_id == 4 && event_id == repro_ev::OscLevel::kEventId)
    return launch<T, Tab, ForcedOsc<repro_data::kGather>, repro_ev::OscLevel,
                  Tables>(a);
  return -1;
}

template <typename T>
int by_data_tableau(int tab_id, int rhs_id, int event_id,
                    const LaunchArgs& a) {
  switch (tab_id) {
    case 0: return by_data<T, Tsit5>(rhs_id, event_id, a);
    case 1: return by_data<T, Dopri5>(rhs_id, event_id, a);
  }
  return -1;
}

template <typename T>
int by_tableau(int tab_id, int rhs_id, int event_id, const LaunchArgs& a) {
  switch (tab_id) {
    case 0: return event_id ? by_event<T, Tsit5>(rhs_id, event_id, a)
                            : by_rhs<T, Tsit5>(rhs_id, a);
    case 1: return event_id ? by_event<T, Dopri5>(rhs_id, event_id, a)
                            : by_rhs<T, Dopri5>(rhs_id, a);
  }
  return -1;
}

int dispatch(int dtype_id, int tab_id, int rhs_id, int event_id,
             const LaunchArgs& a) {
  switch (dtype_id) {
    case 0: return by_tableau<float>(tab_id, rhs_id, event_id, a);
    case 1: return by_tableau<double>(tab_id, rhs_id, event_id, a);
  }
  return -1;
}

}  // namespace repro_erk

// C interface, bound with ctypes by src/repro_torch/kernels/tsit5/kernel.py.
// dtype_id: 0 float32, 1 float64.  tab_id: 0 tsit5, 1 dopri5.  rhs_id: 0
// lorenz, 1 sho, 2 ball, 3 decay.  Returns cudaGetLastError() after the
// launch, or -1 for an unknown id.  Launches on `stream` and does not
// synchronise.
extern "C" int erk_ensemble_launch(int dtype_id, int tab_id, int rhs_id,
                                   const void* u0, const void* p,
                                   const void* saveat, int S, int N, double t0,
                                   double tf, double dt0, double rtol,
                                   double atol, int adaptive,
                                   long long max_iters, void* us,
                                   void* u_final, void* t_final, void* stats,
                                   void* stream) {
  const repro_erk::LaunchArgs a{u0,   p,         saveat,  S,       N,
                     t0,   tf,        dt0,     rtol,    atol,
                     adaptive, max_iters, {0, 0, 0}, us,  u_final, t_final,
                     stats, static_cast<cudaStream_t>(stream)};
  return repro_erk::dispatch(dtype_id, tab_id, rhs_id, 0, a);
}

// The event form: event_id names the functor of events.cuh (kEventId),
// compiled for the pairs of `by_event`; terminal, direction (-1, 0, 1) and
// bisect_iters are the Python Event's.  -1 for an unregistered pair.
extern "C" int erk_ensemble_event_launch(
    int dtype_id, int tab_id, int rhs_id, int event_id, int terminal,
    int direction, int bisect_iters, const void* u0, const void* p,
    const void* saveat, int S, int N, double t0, double tf, double dt0,
    double rtol, double atol, int adaptive, long long max_iters, void* us,
    void* u_final, void* t_final, void* stats, void* stream) {
  if (event_id <= 0) return -1;
  const repro_erk::LaunchArgs a{u0,   p,         saveat,  S,       N,
                     t0,   tf,        dt0,     rtol,    atol,
                     adaptive, max_iters, {terminal, direction, bisect_iters},
                     us,  u_final, t_final,
                     stats, static_cast<cudaStream_t>(stream)};
  return repro_erk::dispatch(dtype_id, tab_id, rhs_id, event_id, a);
}

// The data form: the RHS functor rhs_id (4-6, the forced oscillator in
// gather, onehot and cubic mode) reads the n_data tables of `data` (device
// pointers), `data_shape` (kx, ky per table; ky = 0 in 1-D) and
// `data_grid` (x0, dx, y0, dy per table); event_id 0, or an event of the
// pairs of `by_data` with its terminal, direction and bisect_iters.  -1 for
// an unregistered combination or a bad table count.
extern "C" int erk_ensemble_data_launch(
    int dtype_id, int tab_id, int rhs_id, int event_id, int terminal,
    int direction, int bisect_iters, int n_data, const void* const* data,
    const int* data_shape, const double* data_grid, const void* u0,
    const void* p, const void* saveat, int S, int N, double t0, double tf,
    double dt0, double rtol, double atol, int adaptive, long long max_iters,
    void* us, void* u_final, void* t_final, void* stats, void* stream) {
  repro_erk::LaunchArgs a{u0,   p,         saveat,  S,       N,
                          t0,   tf,        dt0,     rtol,    atol,
                          adaptive, max_iters,
                          {terminal, direction, bisect_iters},
                          us,  u_final, t_final,
                          stats, static_cast<cudaStream_t>(stream)};
  if (!repro_data::make_tables(n_data, data, data_shape, data_grid, a.data))
    return -1;
  switch (dtype_id) {
    case 0: return repro_erk::by_data_tableau<float>(tab_id, rhs_id,
                                                     event_id, a);
    case 1: return repro_erk::by_data_tableau<double>(tab_id, rhs_id,
                                                      event_id, a);
  }
  return -1;
}

// K2's staged launches in one call (`repro_erk::launch_segments`): the
// no-event form over k segments, the first from u0, each from its
// predecessor's final state.  n is the RHS's state size; starts has k + 1
// entries (starts[k] = S).  Returns the first launch's error, or 0.
extern "C" int erk_ensemble_staged_launch(
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
        return repro_erk::dispatch(dtype_id, tab_id, rhs_id, 0, s);
      });
}

// The same for a data form (no event): the tables as in
// `erk_ensemble_data_launch`.
extern "C" int erk_ensemble_data_staged_launch(
    int dtype_id, int tab_id, int rhs_id, int n, int k, const double* t0s,
    const double* tfs, const int* starts, int n_data,
    const void* const* data, const int* data_shape, const double* data_grid,
    const void* u0, const void* p, const void* saveat, int N, double dt0,
    double rtol, double atol, int adaptive, long long max_iters, void* us,
    void* u_mid0, void* u_mid1, void* u_final, void* t_final, void* stats,
    void* stream) {
  repro_erk::LaunchArgs a{u0,       p,         saveat,   0,
                          N,        0.0,       0.0,      dt0,
                          rtol,     atol,      adaptive, max_iters,
                          {0, 0, 0}, us,       u_final,  t_final,
                          stats,    static_cast<cudaStream_t>(stream)};
  if (!repro_data::make_tables(n_data, data, data_shape, data_grid, a.data))
    return -1;
  return repro_erk::launch_segments(
      a, n, dtype_id ? 8 : 4, k, t0s, tfs, starts, u_mid0, u_mid1,
      [&](const repro_erk::LaunchArgs& s) {
        switch (dtype_id) {
          case 0: return repro_erk::by_data_tableau<float>(tab_id, rhs_id, 0,
                                                           s);
          case 1: return repro_erk::by_data_tableau<double>(tab_id, rhs_id,
                                                            0, s);
        }
        return -1;
      });
}
